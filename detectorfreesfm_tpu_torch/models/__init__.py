"""Model zoo: the coarse matcher families and the refinement matcher.

`build_matcher(name, **overrides)` is the port of the JAX package's
models/__init__.py: the matcher module of a family, with keyword overrides
applied to its config dataclass. Every matcher is a PairMatcher
(models/loftr.py) and keeps its contract: `encode_views` (per image:
frames to the family's views), `match_views` (per pair) and `view_bytes`,
and `forward`, their composition: (image0, image1[, valid_hw0,
valid_hw1], return_conf=) -> MatchOutput, and the dense (B, L, S)
confidence too with `return_conf`.
"""

from __future__ import annotations

import dataclasses

LOFTR_FAMILY = ("loftr", "loftr_official", "detectorfree")
ASPAN_NAMES = ("aspan", "aspanformer")
MATCHFORMER_NAMES = ("matchformer",)
EFFICIENTLOFTR_NAMES = ("efficientloftr", "eloftr")
MATCHER_NAMES = (LOFTR_FAMILY + ASPAN_NAMES + MATCHFORMER_NAMES
                 + EFFICIENTLOFTR_NAMES)


def build_matcher(name: str = "loftr", **overrides):
    """The matcher module for `name` (case-insensitive): "loftr" (and its
    aliases "loftr_official", "detectorfree"), "aspan" ("aspanformer"),
    "matchformer" or "efficientloftr" ("eloftr"). Another name raises
    ValueError."""
    name = name.lower()
    if name in LOFTR_FAMILY:
        from .loftr import DetectorFreeMatcher, MatcherConfig

        return DetectorFreeMatcher(
            dataclasses.replace(MatcherConfig(), **overrides))
    if name in ASPAN_NAMES:
        from .aspan import ASpanConfig, ASpanMatcher

        return ASpanMatcher(dataclasses.replace(ASpanConfig(), **overrides))
    if name in MATCHFORMER_NAMES:
        from .matchformer import MatchFormerConfig, MatchFormerMatcher

        return MatchFormerMatcher(
            dataclasses.replace(MatchFormerConfig(), **overrides))
    if name in EFFICIENTLOFTR_NAMES:
        from .efficientloftr import (EfficientLoFTRConfig,
                                     EfficientLoFTRMatcher)

        return EfficientLoFTRMatcher(
            dataclasses.replace(EfficientLoFTRConfig(), **overrides))
    raise ValueError(f"unknown matcher '{name}'")
