"""minicpm3-4b [hf:openbmb/MiniCPM3-4B; hf]: 62L d_model=2560 40H MLA
d_ff=6400 vocab=73448 (padded to 73472 for 16-way TP)."""
from repro_torch.models.mla import MLAConfig
from repro_torch.models.transformer import LMConfig

ARCH_ID = "minicpm3-4b"
FAMILY = "lm"

CONFIG = LMConfig(
    name=ARCH_ID, n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=6400, vocab_size=73448, attn="mla",
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_dim=64,
                  qk_rope_dim=32, v_head_dim=64),
    grad_accum=4,
)

REDUCED = LMConfig(
    name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256, attn="mla",
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=8,
                  qk_rope_dim=4, v_head_dim=8),
    grad_accum=1, vocab_pad_to=32,
)
