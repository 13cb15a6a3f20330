"""The legacy relation predictors (``veto_tpu/models/relation/legacy``):
the Scene-Graph-Benchmark baselines VETO is compared against, on 4096-d
box-MLP features and per-pair union features instead of VETO's 8x8 maps.
The port has the four that take MEET heads: Motifs, VCTree, Transformer
and TransLike."""

from .context import MaskedEncoder, SHAContext, SHAEncoder, TransformerContext
from .lstm import HighwayDecoderLSTM, MaskedBiLSTM, centerx_perm
from .predictors import (
    LegacyOutput, LSTMContext, MeetRelHeads, MotifPredictor, TransformerPredictor,
    TransLikePredictor,
)
from .vctree import BinaryForest, VCTreeContext, VCTreePredictor, build_vctree

PREDICTORS = {
    "MotifPredictor": MotifPredictor,
    "VCTreePredictor": VCTreePredictor,
    "TransformerPredictor": TransformerPredictor,
    "TransLikePredictor": TransLikePredictor,
}

__all__ = [
    "BinaryForest", "HighwayDecoderLSTM", "LSTMContext", "LegacyOutput",
    "MaskedBiLSTM", "MaskedEncoder", "MeetRelHeads", "MotifPredictor", "PREDICTORS",
    "SHAContext", "SHAEncoder", "TransLikePredictor", "TransformerContext",
    "TransformerPredictor", "VCTreeContext", "VCTreePredictor", "build_vctree",
    "centerx_perm",
]
