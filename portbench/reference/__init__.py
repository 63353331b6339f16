"""The benchmark's plain reference: the engine's step, the raft and etcd
models, the history decoder, the specs and the WGL checker, frozen from
the port and run on the CPU with the plain pop decision.

It imports torch and numpy only: nothing of the program under test, and
neither ``jax`` nor the JAX package. It is given the same seeds as the
program and simulates them again (``simulate``).
"""
