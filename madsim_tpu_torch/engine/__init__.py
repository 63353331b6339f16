"""The batched simulation engine in PyTorch (counterpart of
``madsim_tpu.engine``). Importing it has no side effects: no device is
touched and no kernel is built until an entry point runs."""
