"""meshgraphnet [arXiv:2010.03409; unverified]: 15 MP layers, d_hidden=128,
sum aggregator, 2-layer MLPs."""
from repro_torch.models.gnn.meshgraphnet import MGNConfig

ARCH_ID = "meshgraphnet"
FAMILY = "gnn"

CONFIG = MGNConfig(n_layers=15, d_hidden=128, mlp_layers=2, aggregator="sum")
REDUCED = MGNConfig(n_layers=2, d_hidden=16, mlp_layers=1, aggregator="sum",
                    d_in=8, n_out=4)
