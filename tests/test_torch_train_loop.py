"""The port's training loop against the reference's (CPU).

* The tiny llama (2 layers, d_model 64, vocab 256, float32; the
  reference's ``tests/test_train_infra.py`` setup): the reference's jitted
  ``make_train_step`` and the port's over 3 steps from the same params and
  batches, ``dynasparse_ffn`` on and off, 1 and 4 microbatches.  Loss,
  ``grad_norm``, ``lr`` and ``step`` agree within 1e-5.  Params: within
  twice the reference's own spread between its 1- and 4-microbatch runs
  (3.3e-5 here; the same math summed in another order), and all but 0.1 %
  of the elements within 1e-5.  Why not all within 1e-5: AdamW's
  m / (sqrt(v) + 1e-8) turns a gradient element's relative rounding error
  into an update error of the same relative size, and where a gradient
  element is a sum of large cancelling terms (or near 1e-8) that error
  reaches 1e-3 of the element; at lr 1e-2 the param moves by 1e-5.
* One float32 step of the smoke jamba (dropless MoE) against the
  reference's (the other families: ``tests/test_torch_train_grad.py``).
* ``Trainer``: the mirror of the reference's failure-restart test, and
  ``launch.train.main`` with ``--fail-at`` on the CPU.
"""
import functools
import re

import jax
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.data.tokens import TokenPipeline as JTokenPipeline
from repro.models import model_zoo as j_zoo
from repro.train.optimizer import AdamW as JAdamW
from repro.train.trainer import TrainState as JTrainState
from repro.train.trainer import make_train_step as j_make_train_step
from repro_torch.configs import smoke_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import train as train_cli
from repro_torch.models import model_zoo
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import tree as tree_lib
from repro_torch.train.optimizer import AdamW
from repro_torch.train.trainer import Trainer, TrainState, make_train_step
from torch_train_pairs import (METRIC_TOL, OPT, _flat, _j_batch, _np,
                               _t_batch, family_step)

TINY = dict(n_layers=2, d_model=64, vocab_size=256, dtype="float32")
STEPS = 3


@functools.lru_cache(maxsize=None)
def _reference_run(dyn, mb):
    """The reference's jitted steps: (params in the port's layout, per-step
    metrics)."""
    cfg = j_smoke("llama3.2-1b", **TINY, dynasparse_ffn=dyn)
    bundle = j_zoo.build(cfg)
    opt = JAdamW(**OPT)
    step = jax.jit(j_make_train_step(bundle.loss_fn, opt,
                                     num_microbatches=mb))
    params = bundle.init_params(jax.random.PRNGKey(0))
    state = JTrainState(params, opt.init(params))
    pipe = JTokenPipeline(cfg.vocab_size, 4, 32)
    metrics = []
    for s in range(STEPS):
        state, m = step(state, _j_batch(pipe.batch_for_step(s)))
        metrics.append({k: float(v) for k, v in m.items()})
    tcfg = smoke_config("llama3.2-1b", **TINY, dynasparse_ffn=dyn)
    return (_np(params), model_zoo.params_from_reference(
        _np(state.params), tcfg, device="cpu"), metrics)


@pytest.mark.parametrize("mb", [1, 4])
@pytest.mark.parametrize("dyn", [False, True])
def test_train_step_matches_the_reference(dyn, mb):
    init_np, want, want_metrics = _reference_run(dyn, mb)
    cfg = smoke_config("llama3.2-1b", **TINY, dynasparse_ffn=dyn)
    bundle = model_zoo.build(cfg, device="cpu")
    opt = AdamW(**OPT)
    step = make_train_step(bundle.loss_fn, opt, num_microbatches=mb,
                           decay=model_zoo.decay_mask(cfg))
    params = model_zoo.params_from_reference(init_np, cfg, device="cpu")
    state = TrainState(params, opt.init(params))
    pipe = TokenPipeline(cfg.vocab_size, 4, 32)
    for s in range(STEPS):
        state, m = step(state, _t_batch(pipe.batch_for_step(s)))
        for k, w in want_metrics[s].items():
            assert abs(float(m[k]) - w) <= METRIC_TOL * max(1.0, abs(w)), \
                (s, k, float(m[k]), w)
    spread = max(float((a - b).abs().max()) for a, b in zip(
        _flat(_reference_run(dyn, 1)[1]), _flat(_reference_run(dyn, 4)[1])))
    got, ref = _flat(state.params), _flat(want)
    worst = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    beyond = sum(int(((a - b).abs() > 1e-5).sum()) for a, b in zip(got, ref))
    total = sum(a.numel() for a in got)
    assert worst <= max(1e-5, 2 * spread), (worst, spread)
    assert beyond <= 1e-3 * total, (beyond, total)


class _GradDtypes(AdamW):
    """AdamW recording (grad dtype, param dtype) of every leaf it is
    given."""

    def update(self, grads, state, params, *args, **kw):
        self.__dict__["seen"] = {
            (g.dtype, p.dtype) for g, p in zip(
                tree_lib.flatten(grads)[0], tree_lib.flatten(params)[0])}
        return super().update(grads, state, params, *args, **kw)


def test_microbatches_accumulate_in_float32():
    """The reference's equivalence test in the port: 4 microbatches give
    the 1-microbatch step's loss and params; their grads reach AdamW in
    float32, one microbatch's in each param's dtype (bf16 matrices,
    float32 norm scales)."""
    cfg = smoke_config("llama3.2-1b", **{**TINY, "dtype": "bfloat16"})
    bundle = model_zoo.build(cfg, device="cpu")
    params = bundle.init_params(0)
    batch = _t_batch(TokenPipeline(cfg.vocab_size, 4, 32).batch_for_step(0))
    runs = []
    for mb in (1, 4):
        opt = _GradDtypes(**OPT)
        state = TrainState(params, opt.init(params))
        runs.append(make_train_step(bundle.loss_fn, opt,
                                    num_microbatches=mb)(state, batch)
                    + (opt.seen,))
    (s1, m1, dt1), (s4, m4, dt4) = runs
    assert dt1 == {(torch.bfloat16, torch.bfloat16),
                   (torch.float32, torch.float32)}
    assert {g for g, _ in dt4} == {torch.float32}
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-2
    for a, b in zip(_flat(s1.params), _flat(s4.params)):
        torch.testing.assert_close(a, b, atol=2e-2, rtol=0)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b"])
def test_one_float32_step_of_each_family(arch):
    """(the other families: ``tests/test_torch_train_grad.py``)"""
    family_step(arch)


def test_an_unused_param_leaf_raises():
    """The step differentiates every leaf: one the loss does not reach
    is an error, not a silently missing gradient."""
    opt = AdamW(**OPT)
    params = {"w": torch.ones(3), "unused": torch.ones(2)}
    step = make_train_step(lambda p, b: (p["w"] * b["x"]).sum(), opt)
    with pytest.raises(RuntimeError, match="not have been used"):
        step(TrainState(params, opt.init(params)), {"x": torch.ones(3)})


def _tiny_setup():
    cfg = smoke_config("llama3.2-1b", n_layers=2, d_model=64, vocab_size=256)
    bundle = model_zoo.build(cfg, device="cpu")
    opt = AdamW(**OPT)
    step = make_train_step(bundle.loss_fn, opt,
                           decay=model_zoo.decay_mask(cfg))
    params = bundle.init_params(0)
    pipe = TokenPipeline(cfg.vocab_size, 4, 32)
    return step, TrainState(params, opt.init(params)), \
        lambda s: _t_batch(pipe.batch_for_step(s))


def test_trainer_failure_restart_is_exact(tmp_path):
    """The reference's test in the port: crash at step 7, restart from the
    checkpoint; the final state equals the uninterrupted run's (bitwise:
    the CPU steps are deterministic)."""
    d = str(tmp_path / "ck")
    step, state0, batch_for = _tiny_setup()
    ref = state0
    for s in range(10):
        ref, _ = step(ref, batch_for(s))
    tr = Trainer(step, batch_for, state0, ckpt_dir=d, ckpt_every=1,
                 log_every=1000, failure_at_step=7)
    with pytest.raises(RuntimeError):
        tr.run(10, log=lambda *_: None)
    ckpt.wait()
    step2, fresh, _ = _tiny_setup()
    tr2 = Trainer(step2, batch_for, fresh, ckpt_dir=d, ckpt_every=100,
                  log_every=1000)
    assert tr2.maybe_restore()
    assert tr2.step == 7 and int(tr2.state.opt.step) == 7
    tr2.run(3, log=lambda *_: None)
    for a, b in zip(_flat(ref.params), _flat(tr2.state.params)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
        assert torch.equal(a, b)
    assert ckpt.latest_step(d) == 10


def test_trainer_counts_stragglers(monkeypatch):
    """A step 9x the rolling median (after 5 steps) is logged and
    counted."""
    import repro_torch.train.trainer as trainer_mod

    walls = iter([1.0] * 6 + [9.0])
    clock = {"t": 0.0}

    def fake_step(state, batch):
        clock["t"] += next(walls)
        return state, {"loss": torch.tensor(1.0)}

    monkeypatch.setattr(trainer_mod.time, "perf_counter",
                        lambda: clock["t"])
    logs = []
    tr = Trainer(fake_step, lambda s: {}, None, log_every=1000)
    tr.run(7, log=logs.append)
    assert tr.straggler_events == 1
    assert logs == ["[straggler] step 6: 9.000s vs median 1.000s"]


def test_train_cli_restarts_from_its_checkpoint(tmp_path, capsys):
    """``launch.train.main`` on the CPU with an injected failure: it
    restores step 2's checkpoint and ends where an uninterrupted run
    ends."""
    args = ["--device", "cpu", "--steps", "4", "--batch", "4", "--seq",
            "32", "--d-model", "64", "--n-layers", "2", "--ckpt-every", "2"]
    whole = train_cli.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    out = capsys.readouterr().out
    assert re.search(r"arch=llama3.2-1b params=[\d.]+M devices=1 "
                     r"resumed=False step=0", out)
    restarted = train_cli.main(args + ["--ckpt-dir", str(tmp_path / "b"),
                                       "--fail-at", "2"])
    out = capsys.readouterr().out
    assert "FAILURE: injected failure at step 2; restarting from last " \
           "checkpoint..." in out
    assert re.search(r"done: \{'loss': [\d.]+, 'grad_norm': [\d.]+, 'lr': "
                     r"[\d.e-]+, 'step': 4.0\} straggler_events=0", out)
    assert restarted.step == whole.step == 4
    for a, b in zip(_flat(whole.state), _flat(restarted.state)):
        assert torch.equal(a, b)
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) == [
        "LATEST", "step_00000002", "step_00000004"]
    # a second call resumes from the last checkpoint and has nothing to do
    again = train_cli.main(args + ["--ckpt-dir", str(tmp_path / "b")])
    assert "resumed=True step=4" in capsys.readouterr().out
    assert again.step == 4
