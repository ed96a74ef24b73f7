"""The plain reference: softened all-pairs gravity, its VJP, the energy,
the Euler and leapfrog updates and a rollout gradient, in plain PyTorch.

It imports nothing of the port and nothing of JAX, and takes nothing the
program made: the benchmark hands it the same inputs it hands the program,
and it reads the program's outputs only to judge them.
"""
