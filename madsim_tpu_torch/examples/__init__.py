"""Host-tier workloads written against the port's runtime."""
