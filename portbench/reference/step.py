"""The reference's first training steps, reduced to what the check compares.

Adam at the configuration's learning rate (betas 0.9 / 0.999, eps 1e-8) over
every parameter that takes a gradient, on the loss pack's weighted means, in
float32 with TF32 off for both matrix products and convolutions.
"""

from __future__ import annotations

import torch


def fp8_fake_quant(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale (its largest
    magnitude at 448), in the forward; the identity in the backward."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


def leaf_norms(tensors) -> torch.Tensor:
    norms = [t.detach().float().norm() for t in tensors]
    return torch.stack(norms) if norms else torch.zeros(0)


def reference_steps(reference, cfg: dict, weights: dict, batches, device,
                    fake_quant=None) -> dict:
    """Run ``len(batches)`` steps of the reference class ``reference`` (the
    cell's, ``harness.load_cell``) from ``weights`` ({name: tensor}) and
    return, as CPU tensors and floats: ``losses`` (loss_total of each
    step), ``names`` (the parameters that took a gradient at step 1),
    ``grad`` (their step-1 gradient norms), ``change`` (the norms of their
    change over all steps), ``bn_names`` / ``bn_change`` (the norms of each
    BatchNorm buffer's change), ``terms`` (the loss pack's means at step 1)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False  # no autotuning of shapes run three times
    try:
        model = reference(cfg, fake_quant).to(device)
        missing = model.load_state_dict(weights, strict=False).missing_keys
        missing = [k for k in missing if "running_" not in k]
        if missing:
            raise KeyError(f"no weights for {missing[:5]}")
        model.train()
        params = dict(model.named_parameters())
        start = {k: p.detach().clone() for k, p in params.items()}
        buffers = dict(model.named_buffers())
        bn_start = {k: b.detach().clone() for k, b in buffers.items()}
        opt = torch.optim.Adam(params.values(), lr=float(cfg["lr"]))
        w = model.weights()
        losses, names, grad, terms = [], None, None, {}
        for batch in batches:
            pack = model.loss_pack(*(t.to(device) for t in batch))
            total = sum(w[k] * v.mean() for k, v in pack.items())
            opt.zero_grad(set_to_none=True)
            total.backward()
            if names is None:
                terms = {k: float(v.detach().mean()) for k, v in pack.items()}
                names = [k for k, p in params.items() if p.grad is not None]
                grad = leaf_norms(params[k].grad for k in names).cpu()
            opt.step()
            losses.append(float(total.detach()))
        change = leaf_norms(params[k] - start[k] for k in names).cpu()
        bn_names = sorted(buffers)
        bn_change = leaf_norms(buffers[k] - bn_start[k] for k in bn_names).cpu()
        return {"losses": losses, "names": names, "grad": grad, "change": change,
                "bn_names": bn_names, "bn_change": bn_change, "terms": terms}
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.benchmark) = saved
