"""The CLAP towers of the port (counterpart of
``clap2diffusion_tpu/models/clap``): the log-mel frontend, the HTSAT audio
tower, the RoBERTa text tower, their converters, and
``audio_text_similarity``."""

import torch


def audio_text_similarity(audio_emb: torch.Tensor, text_emb: torch.Tensor,
                          logit_scale: float = 1.0) -> torch.Tensor:
    """Cosine-similarity matrix of CLAP embeddings [Na, 512] x [Nt, 512] ->
    [Na, Nt], times ``logit_scale`` (pass a checkpoint's
    ``exp(logit_scale_a)`` for its calibrated logits)."""
    a = audio_emb / (torch.linalg.norm(audio_emb, dim=-1, keepdim=True) + 1e-8)
    t = text_emb / (torch.linalg.norm(text_emb, dim=-1, keepdim=True) + 1e-8)
    return logit_scale * (a @ t.T)
