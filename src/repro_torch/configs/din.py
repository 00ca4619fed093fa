"""din [arXiv:1706.06978; paper]: embed_dim=18, seq_len=100,
attention MLP 80-40, prediction MLP 200-80, target attention.

Tables: 10M items / 1K categories (taobao-scale item table; the embedding
LOOKUP is the hot path)."""
from repro_torch.models.din import DINConfig

ARCH_ID = "din"
FAMILY = "recsys"

CONFIG = DINConfig(embed_dim=18, seq_len=100, attn_mlp=(80, 40),
                   mlp=(200, 80), n_items=10 * 1024 * 1024, n_cates=1_024)
REDUCED = DINConfig(embed_dim=8, seq_len=12, attn_mlp=(16, 8), mlp=(24, 12),
                    n_items=1_000, n_cates=16)
