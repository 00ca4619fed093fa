"""olmoe-1b-7b [arXiv:2409.02060; hf]: 16L d_model=2048 16H (GQA kv=16)
d_ff=1024 (per expert) vocab=50304, MoE 64 experts top-8."""
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

ARCH_ID = "olmoe-1b-7b"
FAMILY = "lm"

CONFIG = LMConfig(
    name=ARCH_ID, n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab_size=50304, qk_norm=True,  # OLMoE uses qk-norm
    moe=MoEConfig(n_experts=64, top_k=8, d_ff=1024),
    grad_accum=8,
    # the reference's residual constraint off for the MoE dispatch (its
    # §Perf D1); the constraint is an identity in the port
    act_batch_sharding=False,
)

REDUCED = LMConfig(
    name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256, qk_norm=True,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=32),
    grad_accum=1, vocab_pad_to=32,
)
