"""qwen3-14b [hf:Qwen/Qwen3-8B family; hf]: 40L d_model=5120 40H (GQA kv=8)
d_ff=17408 vocab=151936, qk-norm."""
from repro_torch.models.transformer import LMConfig

ARCH_ID = "qwen3-14b"
FAMILY = "lm"

CONFIG = LMConfig(
    name=ARCH_ID, n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
    d_head=128, d_ff=17408, vocab_size=151936, qk_norm=True,
    grad_accum=8,
)

REDUCED = LMConfig(
    name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_head=8, d_ff=128, vocab_size=256, qk_norm=True,
    grad_accum=1, vocab_pad_to=32,
)
