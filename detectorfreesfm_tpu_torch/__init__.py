"""PyTorch/CUDA port of the JAX matching system, for one NVIDIA Hopper GPU.

The JAX package beside it stays the reference; this package
imports only torch, numpy and the standard library, and keeps its own copies
of the host-side code it needs. Ported so far: LoFTR-class pair matching
(`match.engine.PairMatchingEngine`) with the bundled flax weights
(`utils.checkpoint.load_matcher_params`) and the hand-written CUDA
dual-softmax kernels (`ops.fused_dsm`); beneath the mapper, the geometry
(`core`), the RANSAC, PnP and bundle-adjustment estimators and the track
builder (`sfm`), and the match and model stores (`data.h5io`,
`data.colmap_io`, `data.database`, `sfm.reconstruction`); above them the
incremental mapper (`sfm.mapper`), multiview refinement (`refine.loop`),
image IO without PIL (`data.images`, `data.png`), pose evaluation
(`eval.pose_auc`), the scene pipeline (`pipeline.reconstruct_scene`) and
the `reconstruct` verb (`python -m detectorfreesfm_tpu_torch.cli`).

Entry points take `device=None`, which means "cuda"; they raise when CUDA is
absent unless the caller asks for `device="cpu"`.
"""
