"""Host-level work distribution: chunkers, the scene queue and progress
(parallel/orchestrate.py). The JAX package's device mesh (parallel/mesh.py)
has no counterpart yet: the port runs on one card (ROADMAP item 19)."""
