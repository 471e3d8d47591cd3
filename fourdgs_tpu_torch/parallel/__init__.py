"""Multi-GPU training and rendering over torch.distributed
(counterpart: fourdgs_tpu/parallel): a ("data", "tile") mesh of ranks
(`mesh.py`), the torchrun wiring and per-rank batch slices
(`multihost.py`), collectives with gradients (`_collectives.py`), and the
tile-sharded train step and eval render (`sharded.py`)."""
