"""The port's ``Ranger`` (``train/ranger.py``) against the JAX package's
``ranger`` on the CPU: 13 steps from the same parameters and gradients
(rank 1, 2 and 4, each in its package's layout: JAX (in, out) and HWIO,
torch (out, in) and OIHW), with weight decay 0 and 0.01. The 13 steps cross
the rectifier's switch (N_sma > 5 from step 6 on) and the Lookahead syncs at
steps 6 and 12. Parameters within 1e-6 of their largest magnitude (fp32
both sides; the centralising means and the moment updates may round
differently in the last bit)."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from where2edit_tpu.train.ranger import ranger
from where2edit_tpu_torch.train.ranger import Ranger, step_scalars

TOL = 1e-6
STEPS = 13
SHAPES = {"bias": (6,), "linear": (5, 7), "conv": (3, 3, 4, 6)}  # JAX layouts


def _to_torch(a: np.ndarray) -> np.ndarray:
    """JAX layout → torch layout: (in, out) → (out, in), HWIO → OIHW."""
    if a.ndim == 2:
        return a.T.copy()
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1).copy()
    return a.copy()


def _run_jax(params: dict, grads: list, wd: float) -> list:
    opt = ranger(0.5, weight_decay=wd)
    p = jax.tree.map(jnp.asarray, params)
    state = opt.init(p)
    update = jax.jit(opt.update)
    out = []
    for g in grads:
        u, state = update(jax.tree.map(jnp.asarray, g), state, p)
        p = jax.tree.map(lambda a, b: a + b, p, u)
        out.append({k: _to_torch(np.asarray(v)) for k, v in p.items()})
    return out


def _torch_params(params: dict) -> dict:
    return {k: torch.nn.Parameter(torch.from_numpy(_to_torch(v))) for k, v in params.items()}


def _step(opt, tp: dict, g: dict) -> None:
    for k, p in tp.items():
        p.grad = torch.from_numpy(_to_torch(g[k]))
    opt.step()


def _problem(seed: int = 0):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(STEPS)]
    return params, grads


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_torch_ranger_matches_jax(wd):
    params, grads = _problem()
    want = _run_jax(params, grads, wd)
    tp = _torch_params(params)
    opt = Ranger(list(tp.values()), lr=0.5, weight_decay=wd)
    for step, g in enumerate(grads, 1):
        _step(opt, tp, g)
        for k, p in tp.items():
            w = want[step - 1][k]
            err = np.abs(p.detach().numpy() - w).max() / np.abs(w).max()
            assert err <= TOL, (step, k, err)
    assert all(s["step"] == STEPS for s in opt.state.values())


def test_torch_ranger_rectifier_switch_and_lookahead():
    """Before the switch (steps 1-5) the update is m / bias1 and no NaN is
    formed; the slow copy starts as a copy of the parameters and the fast
    weights equal it right after each sync."""
    switched = [step_scalars(s, 0.5, 0.95, 0.999, 5)[0] for s in range(1, STEPS + 1)]
    assert switched == [s >= 6 for s in range(1, STEPS + 1)]
    params, grads = _problem(1)
    tp = _torch_params(params)
    opt = Ranger(list(tp.values()), lr=0.5)
    start = {k: p.detach().clone() for k, p in tp.items()}
    for step, g in enumerate(grads, 1):
        _step(opt, tp, g)
        for k, p in tp.items():
            slow = opt.state[p]["slow_buffer"]
            assert torch.isfinite(p).all() and slow.data_ptr() != p.data_ptr()
            if step % 6 == 0:
                assert torch.equal(p, slow), (step, k)
            elif step < 6:
                assert torch.equal(slow, start[k]), (step, k)


def test_torch_ranger_centralizes_all_but_dim0():
    """Gradient centralisation over every dim but dim 0 (torch's output
    dim): a rank-2 gradient that is constant along dim 1 is removed whole,
    so the weight does not move; a bias (rank 1) is not centred."""
    w = torch.nn.Parameter(torch.randn(4, 5, generator=torch.Generator().manual_seed(0)))
    b = torch.nn.Parameter(torch.zeros(4))
    opt = Ranger([w, b], lr=0.5)
    w0 = w.detach().clone()
    w.grad = torch.arange(4.0)[:, None].expand(4, 5).contiguous()
    b.grad = torch.ones(4)
    opt.step()
    assert torch.equal(w, w0)
    assert (b != 0).all()


def test_torch_ranger_state_dict_resumes_exactly():
    """A run saved after 7 steps and loaded into a fresh optimizer (over
    fresh parameters holding the saved values) ends where an uninterrupted
    13-step run ends, bit for bit."""
    params, grads = _problem(2)
    tp = _torch_params(params)
    opt = Ranger(list(tp.values()), lr=0.5, weight_decay=0.01)
    for g in grads:
        _step(opt, tp, g)

    tp2 = _torch_params(params)
    opt2 = Ranger(list(tp2.values()), lr=0.5, weight_decay=0.01)
    for g in grads[:7]:
        _step(opt2, tp2, g)
    saved = {"params": {k: p.detach().clone() for k, p in tp2.items()},
             "opt": opt2.state_dict()}
    buf = io.BytesIO()
    torch.save(saved, buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)
    tp3 = {k: torch.nn.Parameter(v) for k, v in saved["params"].items()}
    opt3 = Ranger(list(tp3.values()), lr=0.5, weight_decay=0.01)
    opt3.load_state_dict(saved["opt"])
    for g in grads[7:]:
        _step(opt3, tp3, g)
    for k in tp:
        assert torch.equal(tp[k], tp3[k]), k
