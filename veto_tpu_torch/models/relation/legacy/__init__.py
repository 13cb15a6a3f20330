"""The legacy relation predictors (``veto_tpu/models/relation/legacy``):
the Scene-Graph-Benchmark baselines VETO is compared against, on 4096-d
box-MLP features and per-pair union features instead of VETO's 8x8 maps.
The port has the four that take MEET heads (Motifs, VCTree, Transformer
and TransLike) and the message-passing ones (IMP, BGNN, GPSNet, MSDN)."""

from .bgnn import (
    BGNNContext, BGNNPredictor, GatedMessageUnit, GPSNetContext, GPSNetPredictor,
    MessageFusion, MSDNPredictor,
)
from .context import (
    MaskedEncoder, PairwiseFeatureExtractor, SHAContext, SHAEncoder,
    TransformerContext,
)
from .lstm import HighwayDecoderLSTM, MaskedBiLSTM, centerx_perm
from .predictors import (
    GRUCell, IMPPredictor, LegacyOutput, LSTMContext, MeetRelHeads, MotifPredictor,
    TransformerPredictor, TransLikePredictor,
)
from .vctree import BinaryForest, VCTreeContext, VCTreePredictor, build_vctree

PREDICTORS = {
    "MotifPredictor": MotifPredictor,
    "VCTreePredictor": VCTreePredictor,
    "TransformerPredictor": TransformerPredictor,
    "TransLikePredictor": TransLikePredictor,
    "IMPPredictor": IMPPredictor,
    "BGNNPredictor": BGNNPredictor,
    "GPSNetPredictor": GPSNetPredictor,
    "MSDNPredictor": MSDNPredictor,
}
# the predictors that take MEET heads (the JAX model's ``MEET_CAPABLE``)
MEET_CAPABLE = ("MotifPredictor", "VCTreePredictor", "TransformerPredictor",
                "TransLikePredictor")
# the predictors that take the relation-confidence keys
# (``relation.rel_aware``, ``relation.mp_valid_pairs``)
REL_AWARE = ("BGNNPredictor", "MSDNPredictor")

__all__ = [
    "BGNNContext", "BGNNPredictor", "BinaryForest", "build_vctree", "centerx_perm",
    "GatedMessageUnit", "GPSNetContext", "GPSNetPredictor", "GRUCell",
    "HighwayDecoderLSTM", "IMPPredictor", "LegacyOutput", "LSTMContext",
    "MaskedBiLSTM", "MaskedEncoder", "MEET_CAPABLE", "MeetRelHeads",
    "MessageFusion", "MotifPredictor", "MSDNPredictor", "PairwiseFeatureExtractor",
    "PREDICTORS", "REL_AWARE", "SHAContext", "SHAEncoder", "TransformerContext",
    "TransformerPredictor", "TransLikePredictor", "VCTreeContext",
    "VCTreePredictor",
]
