"""whisper-tiny [audio] -- encoder-decoder. [arXiv:2212.04356]

4L enc + 4L dec, d_model=384, 6H MHA, d_ff=1536, vocab=51865, GELU,
LayerNorm, learned positions. The port runs its conv stem
(models/audio.py: conv1 k=3 stride 1 on the 1D Cook-Toom path, conv2 k=3
stride 2 polyphase), at 80 mels and 30 s of audio (3000 frames -> the
encoder's n_ctx of 1500), whose frames feed the encoder
(models/transformer.py: encode, forward_logits / prefill with frames=). A
copy of the JAX package's configs/whisper_tiny.py.
"""

from repro_torch.configs import shrink
from repro_torch.models.config import ArchConfig, EncoderConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab=51865,
    act="gelu",
    pos_emb="learned",
    encoder=EncoderConfig(n_layers=4, n_ctx=1500),
    tie_embeddings=True,
    max_seq=32_768,
)


def smoke() -> ArchConfig:
    return shrink(CONFIG)
