"""equiformer-v2 [arXiv:2306.12059; unverified]: 12 layers, d_hidden=128,
l_max=6, m_max=2, 8 heads, SO(2)/eSCN-restricted equivariant attention."""
from repro_torch.models.gnn.equiformer import EqV2Config

ARCH_ID = "equiformer-v2"
FAMILY = "gnn"

CONFIG = EqV2Config(n_layers=12, d_hidden=128, l_max=6, m_max=2, n_heads=8)
REDUCED = EqV2Config(n_layers=2, d_hidden=16, l_max=2, m_max=1, n_heads=2,
                     d_in=8, n_out=4)
