"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B; hf]: 48L
d_model=2048 16H (GQA kv=16) d_ff=1408 (per expert) vocab=163840,
MoE 64 experts top-6."""
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

ARCH_ID = "moonshot-v1-16b-a3b"
FAMILY = "lm"

CONFIG = LMConfig(
    name=ARCH_ID, n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=163840,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff=1408),
    grad_accum=8,
    # the reference's residual constraint off for the MoE dispatch (its
    # §Perf D1); the constraint is an identity in the port
    act_batch_sharding=False,
)

REDUCED = LMConfig(
    name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=96, vocab_size=512,
    moe=MoEConfig(n_experts=8, top_k=3, d_ff=48),
    grad_accum=1, vocab_pad_to=32,
)
