"""Model substrate of the port: ``layers`` (linears, norms, GQA attention,
SwiGLU FFN), ``ops`` (RMSNorm, RoPE, full-sequence and cache attention,
cross-entropy), ``transformer`` (the decoder LM: ``apply``,
``prefill_chunk``)."""

from repro_torch.models.transformer import LM  # noqa: F401


def build_model(cfg, device=None) -> LM:
    """Factory: a decoder LM on ``device`` (default cuda; raises when no GPU
    is present unless ``device="cpu"``)."""
    return LM(cfg, device)
