"""Oracle constants the models record with (counterpart of
``madsim_tpu.oracle``)."""
