"""DLRM, the paper's own architecture (Table II parameters: embedding dim 92,
average MLP size 682, pooling 70).  Tables are split over the world; the
embedding + All-to-All fused operator sits between the tables and the
interaction."""
from repro_torch.models.dlrm import DLRMConfig

CONFIG = DLRMConfig(
    name="dlrm",
    n_tables=512, table_vocab=1_000_000, embed_dim=92,
    n_dense=13, bottom_mlp=(512, 256, 92),
    top_mlp=(682, 682, 682, 1), pooling=70,
    param_dtype="float32", compute_dtype="float32",
)

FAMILY = "dlrm"
