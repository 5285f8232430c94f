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
image IO without PIL or libjpeg (`data.images`, `data.png`,
`csrc/jpeg.cpp`), pose evaluation
(`eval.pose_auc`), the scene pipeline (`pipeline.reconstruct_scene`) and
the `reconstruct` verb (`python -m detectorfreesfm_tpu_torch.cli`), and
the profiler (`utils.profiler`).

Entry points take `device=None`, which means "cuda"; they raise when CUDA is
absent unless the caller asks for `device="cpu"`.
"""


def reconstruct_scene(*args, **kwargs):
    """Convenience re-export of pipeline.reconstruct_scene (lazy import)."""
    from .pipeline import reconstruct_scene as _f

    return _f(*args, **kwargs)


def build_matcher(*args, **kwargs):
    """Convenience re-export of models.build_matcher (lazy import)."""
    from .models import build_matcher as _f

    return _f(*args, **kwargs)
