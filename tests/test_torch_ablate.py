"""The port's step ablation against ``scripts/ablate_step.py``, on the CPU.

- Its nine loss subsets and its network entries are the JAX script's, read
  from the script's syntax tree (importing the script would import JAX and
  compile).
- The gradient of the subset "depth-only (pixel+smooth)" at 64x128 b2 f32
  (``ssim_impl="xla"``, ``bench.py``'s batch at that size) against the JAX
  package's gradient of the same sum on the same weights (the port's seed,
  carried by ``utils/jax_weights.jax_variables``), with
  tests/test_torch_geom.py's tolerance recipe: per network 2e-2 relative
  L2; tensor by tensor the max error under 0.2 of the tensor's max-abs and
  the median tensor under 5e-3 (the geom step is ill-conditioned in f32 at
  init in both packages); tensors whose gradient is zero up to rounding
  (max-abs under 1e-9) left out of the per-tensor check. One JAX gradient
  compile.
- Every entry runs on the CPU at that size; the timing entry point raises
  without a card.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsupervised_depth_opticalflow_egomotion_torch import ablate_step, bench
from unsupervised_depth_opticalflow_egomotion_torch.config import Config
from unsupervised_depth_opticalflow_egomotion_torch.parallel import build_model
from unsupervised_depth_opticalflow_egomotion_torch.utils.jax_weights import (
    jax_state_dict,
    jax_variables,
)
from unsupervised_depth_opticalflow_egomotion_tpu.config import Config as JConfig
from unsupervised_depth_opticalflow_egomotion_tpu.parallel.train_step import (
    build_model as j_build_model,
)

pytestmark = pytest.mark.quick
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CFG = dict(img_hw=(64, 128), batch_size=2, compute_dtype="float32", ssim_impl="xla")
SUBSET = "depth-only (pixel+smooth)"


def _script_main() -> ast.FunctionDef:
    tree = ast.parse((REPO / "scripts" / "ablate_step.py").read_text())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")


def test_subsets_are_the_jax_scripts():
    """``ALL`` and ``subsets`` evaluated from the script's own statements."""
    statements = [n for n in _script_main().body if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", None) in ("ALL", "subsets")]
    assert len(statements) == 2
    namespace = {}
    exec(compile(ast.Module(body=statements, type_ignores=[]), "ablate_step.py", "exec"), namespace)
    assert ablate_step.ALL == namespace["ALL"]
    assert list(ablate_step.SUBSETS) == list(namespace["subsets"])
    assert ablate_step.SUBSETS == namespace["subsets"]


def test_entries_are_the_jax_scripts():
    """The subsets, then each bare network fwd+bwd and fwd-only, by the
    names the script prints."""
    nets = [n.value for n in ast.walk(_script_main())
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and n.value.endswith(" fwd+bwd")]
    assert len(nets) == 3
    want = list(ablate_step.SUBSETS) + [x for n in nets for x in (n, n.replace("fwd+bwd", "fwd-only"))]
    model = build_model(Config(**CFG), "cpu")
    assert list(ablate_step.entries(model, bench.make_batch(2, 64, 128, "cpu"))) == want


def test_subset_gradient_matches_jax():
    cfg = Config(**CFG)
    model = build_model(cfg, "cpu")
    params, stats = (jax.tree_util.tree_map(np.array, t) for t in jax_variables(model))
    batch = bench.make_batch(2, 64, 128, "cpu")
    keys = ablate_step.SUBSETS[SUBSET]

    jmodel = j_build_model(JConfig(**CFG))

    def loss_fn(p):
        (pack, _), _ = jmodel.apply(
            {"params": p, "batch_stats": stats}, *(jnp.asarray(x.numpy()) for x in batch),
            train=True, method=jmodel.forward_geom, mutable=["batch_stats"],
        )
        return sum(jnp.mean(pack[k]) for k in keys)

    jgrads = jax_state_dict(jax.jit(jax.grad(loss_fn))(params), stats)

    ablate_step.subset_grad(model, batch, keys)
    named = dict(model.named_parameters())
    got = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach() for k, p in named.items()}
    want = {k: torch.as_tensor(np.asarray(jgrads[k])) for k in named}
    live = []
    for net in ("depth_net", "pose_net", "fpyramid", "pwc_model"):
        ks = [k for k in named if k.startswith(net + ".")]
        g = torch.cat([got[k].flatten() for k in ks])
        w = torch.cat([want[k].flatten() for k in ks])
        if w.norm() == 0:
            assert g.norm() == 0, net  # a network the subset does not reach
            continue
        live.append(net)
        assert ((g - w).norm() / w.norm()).item() < 2e-2, net
    assert {"depth_net", "pose_net"} <= set(live), live
    errs = {k: ((got[k] - want[k]).abs().max() / want[k].abs().max()).item()
            for k in named if want[k].abs().max() >= 1e-9}
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    assert worst[0][1] < 0.2, worst
    assert np.median(list(errs.values())) < 5e-3, worst


def test_every_entry_runs_on_cpu():
    """Each call of the ablation once at 64x128 b2 f32: every subset leaves
    finite gradients, on some network; each network's fwd+bwd on every
    parameter of that network."""
    model = build_model(Config(**CFG), "cpu")
    calls = ablate_step.entries(model, bench.make_batch(2, 64, 128, "cpu"))
    net_of = {"depth_net": ("depth_net",), "fpyramid+pwc": ("fpyramid", "pwc_model"),
              "pose_net": ("pose_net",)}
    for name, call in calls.items():
        call()
        grads = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
        assert all(torch.isfinite(g).all() for g in grads.values()), name
        if name.endswith("fwd-only"):
            continue
        nets = next((v for k, v in net_of.items() if name.startswith(k + " ")), None)
        if nets is None:  # a loss subset
            assert grads, name
        else:
            want = {k for k, _ in model.named_parameters() if k.startswith(nets)}
            assert want and want <= set(grads), name


def test_run_needs_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        ablate_step.run(1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ablate_step.run(1)
