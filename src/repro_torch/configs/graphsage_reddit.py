"""graphsage-reddit [arXiv:1706.02216; paper]: 2 layers, d_hidden=128, mean
aggregator, sample sizes 25-10 (shape minibatch_lg uses the assigned 15-10
fanout)."""
from repro_torch.models.gnn.graphsage import SAGEConfig

ARCH_ID = "graphsage-reddit"
FAMILY = "gnn"

CONFIG = SAGEConfig(n_layers=2, d_hidden=128, sample_sizes=(25, 10))
REDUCED = SAGEConfig(n_layers=2, d_hidden=16, sample_sizes=(3, 2),
                     d_in=8, n_out=4)
