"""Shared helpers of the training parity tests: the optimizer settings of
the reference's own trainer tests, batch converters, and one float32
train step of a family's smoke config through both packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import smoke_config as j_smoke
from repro.models import model_zoo as j_zoo
from repro.train.optimizer import AdamW as JAdamW
from repro.train.trainer import TrainState as JTrainState
from repro.train.trainer import make_train_step as j_make_train_step
from repro_torch.configs import smoke_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models import model_zoo
from repro_torch.train import tree as tree_lib
from repro_torch.train.optimizer import AdamW
from repro_torch.train.trainer import TrainState, make_train_step

OPT = dict(lr=1e-2, warmup_steps=2, total_steps=50)
METRIC_TOL = 1e-5


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _flat(tree):
    return [t.detach().float() for t in tree_lib.flatten(tree)[0]]


def _j_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _t_batch(b):
    return {k: torch.from_numpy(np.asarray(v)).long()
            if np.issubdtype(np.asarray(v).dtype, np.integer)
            else torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _dropless(cfg):
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts * cfg.moe.top_k)))


# each family at one period of its layer pattern (deepseek: its dense-first
# layer and one MoE layer), float32, MoE dropless; the grad-norm tolerance
# is METRIC_TOL but for xLSTM (see the test)
FAMILIES = {"deepseek-v2-lite-16b": 2, "jamba-v0.1-52b": 8, "xlstm-125m": 4,
            "whisper-large-v3": 2}
XLSTM_GNORM_TOL = 3e-4


def family_step(arch):
    """Loss, lr and step within 1e-5; params within 1e-5 but at most 0.1 %
    of the elements, whose update the first step's m / (sqrt(v) + 1e-8)
    makes sensitive, each within lr.  The grad norm within 1e-5, but
    xLSTM's within 3e-4: its float32 gradient is ill-conditioned through
    the exponential gates.  Every mixer's VJP agrees within 2.5e-6 of the
    reference's on the same input, but the error grows layer by layer
    going back (1e-4 at the embedding of the 4-layer stack), and a one-ulp
    perturbation of the reference's own params moves its grad norm by
    4e-6 to 4.2e-5 (seeds 2-4, 4 and 8 layers), where the port differs by
    1.9e-6 to 9.3e-5."""
    n_layers = FAMILIES[arch]
    jcfg = _dropless(j_smoke(arch, dtype="float32", n_layers=n_layers))
    tcfg = _dropless(smoke_config(arch, dtype="float32", n_layers=n_layers))
    jb = j_zoo.build(jcfg)
    jopt, topt = JAdamW(**OPT), AdamW(**OPT)
    jp = jb.init_params(jax.random.PRNGKey(2))
    tp = model_zoo.params_from_reference(_np(jp), tcfg, device="cpu")
    pipe = TokenPipeline(tcfg.vocab_size, 2, 32)
    b = pipe.batch_for_step(0)
    if tcfg.encdec is not None:
        b = {"frames": pipe.frames_for_step(0, tcfg.d_model),
             "tokens": b["tokens"][:, :8], "labels": b["labels"][:, :8]}
    js, jm = jax.jit(j_make_train_step(jb.loss_fn, jopt))(
        JTrainState(jp, jopt.init(jp)), _j_batch(b))
    tb = model_zoo.build(tcfg, device="cpu")
    ts, tm = make_train_step(tb.loss_fn, topt,
                             decay=model_zoo.decay_mask(tcfg))(
        TrainState(tp, topt.init(tp)), _t_batch(b))
    for k in ("loss", "grad_norm", "lr", "step"):
        w = float(jm[k])
        tol = (XLSTM_GNORM_TOL if (k, tcfg.xlstm is not None)
               == ("grad_norm", True) else METRIC_TOL)
        assert abs(float(tm[k]) - w) <= tol * max(1.0, abs(w)), \
            (k, float(tm[k]), w)
    want = model_zoo.params_from_reference(_np(js.params), tcfg,
                                           device="cpu")
    got, ref = _flat(ts.params), _flat(want)
    beyond = sum(int(((a - b).abs() > 1e-5).sum()) for a, b in zip(got, ref))
    total = sum(a.numel() for a in got)
    worst = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    assert beyond <= 1e-3 * total and worst <= OPT["lr"], (beyond, worst)
