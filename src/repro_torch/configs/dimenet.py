"""dimenet [arXiv:2003.03123; unverified]: 6 blocks, d_hidden=128,
n_bilinear=8, n_spherical=7, n_radial=6."""
from repro_torch.models.gnn.dimenet import DimeNetConfig

ARCH_ID = "dimenet"
FAMILY = "gnn"

CONFIG = DimeNetConfig(n_blocks=6, d_hidden=128, n_bilinear=8,
                       n_spherical=7, n_radial=6)
REDUCED = DimeNetConfig(n_blocks=2, d_hidden=16, n_bilinear=2,
                        n_spherical=3, n_radial=3, d_in=8, n_out=4)
