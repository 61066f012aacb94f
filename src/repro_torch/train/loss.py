"""Loss functions (counterpart of ``repro/train/loss.py``).

``make_loss_fn(model)`` returns ``loss_fn(params, batch) -> (loss,
metrics)``: for the LM families next-token cross-entropy plus
``aux_weight`` × the MoE load-balance loss.  The reference's enc-dec,
vision, embeds-input and MTP losses belong to models the port does not have
yet and raise."""

from __future__ import annotations

import torch

from repro_torch.models import ops

_NOT_PORTED = {
    "audio": "the enc-dec (whisper) loss",
    "vision": "the vision (ViT) loss",
    "vlm": "the embeds-input (llava) loss",
}


def make_loss_fn(model, *, aux_weight: float = 0.01):
    cfg = model.cfg
    what = _NOT_PORTED.get(cfg.family)
    if what is None and getattr(cfg, "mtp", False):
        what = "the DeepSeek MTP (t+2) loss"
    if what is not None:
        raise NotImplementedError(f"{what} is not ported yet (ROADMAP A11)")

    def lm_loss(params, batch):
        # (B, S+1); the trainer passes its static device buffer, so no
        # copy is made inside the step
        tokens = torch.as_tensor(batch["tokens"]).to(model.device)
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        out = model.apply(params, tokens=inputs)
        loss, acc = ops.cross_entropy(out.logits, labels)
        total = loss + aux_weight * out.aux
        return total, {"ce": loss, "acc": acc, "aux": out.aux, "loss": total}

    return lm_loss
