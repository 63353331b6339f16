"""Device workload models in PyTorch (counterpart of ``madsim_tpu.models``)."""
