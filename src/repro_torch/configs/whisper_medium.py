"""whisper-medium [audio]: 24L enc + 24L dec, d_model=1024 16H (MHA)
d_ff=4096 vocab=51865, enc-dec; conv frontend STUB (input_specs provides
precomputed frame embeddings) [arXiv:2212.04356; unverified]."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865,
    dec_layers=24, dec_seq=448, causal=False,
    policy="tp", supports_long=False)
