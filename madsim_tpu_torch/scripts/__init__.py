"""The command-line drivers of the port: one module per script of the
repository's ``scripts/``, under the same name, each run from the
repository root as ``python -m madsim_tpu_torch.scripts.<name>``.

Each driver keeps its script's flags, exit codes, one JSON line on
stdout, stderr heartbeat and report bytes; only wall times and rates
differ. The drivers of the device tier take ``--device`` (default CUDA,
through ``madsim_tpu_torch.resolve_device``): without a card, and without
``--device cpu``, they exit non-zero naming the reason, and nothing falls
back to the CPU. ``wire_load_demo`` is host tier and runs on the CPU, as
``wire_load`` does.

The map from ``scripts/`` to the port:

============================  ==============================================
``scripts/``                  port
============================  ==============================================
``replay_seed.py``            ``madsim_tpu_torch.scripts.replay_seed``
``sweep_million.py``          ``madsim_tpu_torch.scripts.sweep_million``
``checked_sweep_demo.py``     ``madsim_tpu_torch.scripts.checked_sweep_demo``
``oracle_demo.py``            ``madsim_tpu_torch.scripts.oracle_demo``
``explore_demo.py``           ``madsim_tpu_torch.scripts.explore_demo``
``differential_demo.py``      ``madsim_tpu_torch.scripts.differential_demo``
``stream_smoke.py``           ``madsim_tpu_torch.scripts.stream_smoke``
``obs_smoke.py``              ``madsim_tpu_torch.scripts.obs_smoke``
``steer_demo.py``             ``madsim_tpu_torch.scripts.steer_demo``
``fleet_smoke.py``            ``madsim_tpu_torch.scripts.fleet_smoke``
``multichip_campaign.py``     ``madsim_tpu_torch.scripts.multichip_campaign``
``wire_load_demo.py``         ``madsim_tpu_torch.scripts.wire_load_demo``
``check_determinism.sh``      ``madsim_tpu_torch.scripts.check_determinism``
``wire_load.py``              ``madsim_tpu_torch.wire_load`` (package root)
``profile_step.py``           ``madsim_tpu_torch.profile_step`` (package root)
``bench_megakernel.py``       ``madsim_tpu_torch.bench_megakernel`` (package
                              root)
``bench_packing.py``          none yet: the port's benchmark (ROADMAP item 12)
``bench_pallas.py``           none yet: the port's benchmark (ROADMAP item 12)
``bench_rpc.py``              none yet: the port's benchmark (ROADMAP item 12)
============================  ==============================================

``_cli`` holds what the drivers share: ``--device`` and its refusal
without a card, the one JSON line, and the heartbeat that reads the obs
registry every ``MADSIM_HB_SECONDS``. ``import madsim_tpu_torch`` does
not import this package, and importing a driver imports no torch: each
imports the engine inside ``main``.

Every module guards its entry with ``if __name__ == "__main__":``: the
ranks of ``parallel.World`` and the checker's pool workers import the
main module again.
"""
