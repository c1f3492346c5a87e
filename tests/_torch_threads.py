"""Imported first by every port test file (``tests/test_torch_*.py``):
torch runs one intra-op thread in each test process, as the spawned ranks
of the sharded tests do. The tier-1 command runs six pytest-xdist workers
on the machine's CPUs; with torch's default of a thread per CPU in each of
them, the workers' small eager ops spend more time contending than they
save."""
import torch

torch.set_num_threads(1)
