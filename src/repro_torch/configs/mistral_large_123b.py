"""mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407; unverified]:
88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768."""
from repro_torch.models.transformer import LMConfig

ARCH_ID = "mistral-large-123b"
FAMILY = "lm"

CONFIG = LMConfig(
    name=ARCH_ID, n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8,
    d_head=128, d_ff=28672, vocab_size=32768,
    grad_accum=8,    # 123B activation-memory lever; microbatch 32 divides
                     # the (pod, data) batch shards on both meshes
    # two-level remat (11 groups x 8 layers; the reference's §Perf A3)
    remat_policy="sqrt", remat_group=8,
)

REDUCED = LMConfig(
    name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_head=8, d_ff=160, vocab_size=256,
    grad_accum=1, vocab_pad_to=32,
)
