"""Per-layer metric readers: ``<name>.py`` defines ``read(records)``,
which returns the metric's number from a traced run's records, or None
where the run left nothing to read (the metric is then left out)."""
