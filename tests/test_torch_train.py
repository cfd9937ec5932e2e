"""The port's training path on the CPU: the counterparts of
``tests/test_train.py`` (loss decreases, chunked = full loss, microbatch
= full batch, bitwise crash/resume, int8 moments track f32, checkpoint
round trip) and of ``tests/test_models_smoke.py::test_one_train_step``,
plus parity with the reference: one train step on the same state and
batch, the int8 moment codes, checkpoints written by one package and
resumed by the other, and int8-moment resume (which the reference's
``Trainer`` cannot do: ``ROADMAP.md``, "Red in the reference").

Both packages get the reference's JAX init (``train_state_from_jax``)
and the same numpy batches; JAX runs on the CPU and the port with
``device="cpu"``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import family_batch
from repro.ckpt import checkpoint as JC
from repro.configs import TrainConfig as JTrainConfig
from repro.configs.registry import ASSIGNED
from repro.optim import adamw as JA
from repro.train import trainer as JT
from repro_torch.ckpt import checkpoint as PC
from repro_torch.common.tree import tree_leaves
from repro_torch.configs import TrainConfig, get_config
from repro_torch.data import make_train_data_fn
from repro_torch.models import transformer as PT
from repro_torch.models.convert import train_state_from_jax
from repro_torch.models.registry import get_model
from repro_torch.optim import Q8
from repro_torch.optim import adamw as PA
from repro_torch.train.losses import lm_loss, lm_loss_from_hidden
from repro_torch.train.trainer import Trainer, init_state, make_train_step
from torch_parity import jax_model, one_torch_thread, port_model, reduced_cfg  # noqa: F401


def _tcfg(tmp_path, **kw):
    return TrainConfig(ckpt_dir=str(tmp_path / "ckpt"), **kw)


def _reduced(arch="qwen3-0.6b"):
    return get_model(arch, get_config(arch).reduced())


def _np_batch(cfg, B, T):
    batch = {k: np.asarray(v) for k, v in family_batch(cfg, B, T).items()}
    batch["labels"] = batch["tokens"]
    return batch


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _port_params_like_jax(params):
    """The port's param leaves in JAX's flattening order (sorted keys)."""
    if isinstance(params, dict):
        return [x for k in sorted(params) for x in _port_params_like_jax(params[k])]
    return [params.detach().numpy()]


def _params_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True))


# ------------------------------------------------ tests/test_train.py ----
def test_loss_decreases_qwen(tmp_path):
    model = _reduced()
    tcfg = _tcfg(tmp_path, global_batch=8, seq_len=32, total_steps=40, lr=5e-3,
                 warmup_steps=5, remat=True)
    tr = Trainer(model, tcfg, make_train_data_fn(model.cfg, tcfg), log_every=5,
                 device="cpu")
    losses = [l for _, l in tr.run()]
    assert losses[-1] < losses[0] - 0.1, losses


def test_chunked_loss_equals_full():
    model = _reduced()
    cfg = model.cfg
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = _torch(_np_batch(cfg, 2, 20))
    labels = torch.randint(0, cfg.vocab_size, (2, 20), generator=torch.Generator().manual_seed(9))
    labels[0, :5] = -100
    with torch.no_grad():
        hidden, _ = PT.train_hidden(params, cfg, batch)
        l1, n1 = lm_loss_from_hidden(hidden, labels, params["embed"], chunk=7,
                                     v_real=cfg.vocab_size)
        l2, n2 = lm_loss(PT.unembed(params, cfg, hidden), labels, v_real=cfg.vocab_size)
    assert abs(float(l1) - float(l2)) < 1e-4
    assert float(n1) == float(n2) == 35


def test_microbatch_matches_full_batch(tmp_path):
    model = _reduced()
    kw = dict(global_batch=4, seq_len=16, total_steps=1, remat=False, grad_clip=1e9)
    t_full, t_micro = _tcfg(tmp_path, **kw), _tcfg(tmp_path, microbatch=2, **kw)
    batch = _torch(_np_batch(model.cfg, 4, 16))
    s1 = init_state(model, torch.Generator().manual_seed(0), t_full, device="cpu")
    s2 = init_state(model, torch.Generator().manual_seed(0), t_micro, device="cpu")
    s1, _ = make_train_step(model, t_full)(s1, batch)
    s2, _ = make_train_step(model, t_micro)(s2, batch)
    for a, b in zip(tree_leaves(s1["params"]), tree_leaves(s2["params"]), strict=True):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=0)


@pytest.mark.parametrize("int8_moments", [False, True])
def test_crash_resume_bitwise(tmp_path, int8_moments):
    """An uninterrupted run against one that crashes after step 6 and
    resumes from the step-4 checkpoint: the final params are bitwise
    equal, with f32 and with int8 (``Q8``) moments."""
    model = _reduced()
    tcfg = _tcfg(tmp_path, global_batch=4, seq_len=16, total_steps=10, ckpt_every=4,
                 remat=False, int8_moments=int8_moments)
    data_fn = make_train_data_fn(model.cfg, tcfg)
    ref = Trainer(model, dataclasses.replace(tcfg, ckpt_dir=str(tmp_path / "ref")),
                  data_fn, device="cpu")
    ref.run()
    t1 = Trainer(model, tcfg, data_fn, device="cpu")
    with pytest.raises(RuntimeError, match="simulated failure at step 6"):
        t1.run(crash_at=6)
    t2 = Trainer(model, tcfg, data_fn, device="cpu")          # auto-resume from step 4
    assert t2.start_step == 4
    assert isinstance(t2.state["opt"]["mu"]["embed"], Q8) == int8_moments
    t2.run()
    assert _params_equal(ref.state["params"], t2.state["params"])


def test_int8_moments_track_fp32(tmp_path):
    model = _reduced()
    t8 = _tcfg(tmp_path, global_batch=4, seq_len=16, total_steps=5, int8_moments=True,
               remat=False)
    tf = dataclasses.replace(t8, int8_moments=False)
    data_fn = make_train_data_fn(model.cfg, t8)
    s8 = init_state(model, torch.Generator().manual_seed(0), t8, device="cpu")
    sf = init_state(model, torch.Generator().manual_seed(0), tf, device="cpu")
    assert isinstance(s8["opt"]["nu"]["blocks"]["wq"], Q8)
    f8, ff = make_train_step(model, t8), make_train_step(model, tf)
    for i in range(5):
        b = data_fn(i)
        b["labels"] = b["tokens"]
        s8, m8 = f8(s8, b)
        sf, mf = ff(sf, b)
    assert abs(float(m8["loss"]) - float(mf["loss"])) < 0.1


def test_checkpoint_roundtrip_structure(tmp_path):
    model = _reduced("olmoe-1b-7b")
    tcfg = _tcfg(tmp_path, global_batch=2, seq_len=8, total_steps=1, int8_moments=True)
    state = init_state(model, torch.Generator().manual_seed(0), tcfg, device="cpu")
    state["params"]["ln_f"] = state["params"]["ln_f"].to(torch.bfloat16)   # narrowed back
    PC.save(tcfg.ckpt_dir, 7, state)
    assert PC.latest_step(tcfg.ckpt_dir) == 7
    back = PC.load(tcfg.ckpt_dir, 7, device="cpu")
    assert isinstance(back["opt"]["mu"]["blocks"]["moe"]["router"], Q8)
    a, b = tree_leaves(state), tree_leaves(back)
    assert len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y)
                                    for x, y in zip(a, b))


# ----------------------------------- tests/test_models_smoke.py ----------
@pytest.mark.parametrize("arch", ASSIGNED)
def test_one_train_step(tmp_path, arch):
    model = _reduced(arch)
    tcfg = _tcfg(tmp_path, global_batch=2, seq_len=16, total_steps=2, remat=False,
                 warmup_steps=0)                            # a nonzero lr at step 0
    state = init_state(model, torch.Generator().manual_seed(0), tcfg, device="cpu")
    batch = _torch(_np_batch(model.cfg, 2, 16))
    new, m = make_train_step(model, tcfg)(state, batch)
    assert bool(torch.isfinite(m["loss"])) and float(m["loss"]) > 0, arch
    assert all(bool(torch.isfinite(p).all()) for p in tree_leaves(new["params"]))
    assert not _params_equal(state["params"], new["params"])


# ------------------------------------------------ parity with the reference
def _jax_state(cfg, arch, int8=False):
    jm = jax_model(cfg, arch)
    params = jm.init(jax.random.PRNGKey(0))
    return jm, {"params": params, "opt": JA.adamw_init(params, int8)}


@pytest.mark.parametrize("loss_impl", ["chunked", "vtiled"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "olmoe-1b-7b", "internvl2-2b"])
def test_train_step_matches_reference(tmp_path, arch, loss_impl):
    """One step from the same state on the same batch: loss, gnorm and lr
    within 1e-5 relative, every param within 1e-4 (the MoE's aux loss and
    the VLM's label padding included).  The port runs with remat, so its
    checkpointed layers (and K2's second forward) are on the path."""
    cfg = reduced_cfg(arch)
    kw = dict(global_batch=2, seq_len=16, total_steps=4, warmup_steps=0, lr=1e-3,
              loss_impl=loss_impl, grad_clip=0.5)
    jm, jstate = _jax_state(cfg, arch)
    batch = _np_batch(cfg, 2, 16)
    jnew, jm_ = jax.jit(JT.make_train_step(jm, JTrainConfig(remat=False, **kw)))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    pstate = train_state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    pnew, pm = make_train_step(port_model(cfg, arch), _tcfg(tmp_path, remat=True, **kw))(
        pstate, _torch(batch))
    for key in ("loss", "gnorm", "lr"):
        np.testing.assert_allclose(float(pm[key]), float(jm_[key]), rtol=1e-5, err_msg=key)
    assert float(pm["gnorm"]) > kw["grad_clip"]                  # the clip is on the path
    moved = 0.0
    for got, want, init in zip(_port_params_like_jax(pnew["params"]), _np_leaves(jnew["params"]),
                               _np_leaves(jstate["params"]), strict=True):
        np.testing.assert_allclose(got, want, atol=1e-4)
        moved = max(moved, float(np.abs(got - init).max()))
    assert moved > 5e-4                          # lr 1e-3: the step moved the params
    assert int(pnew["opt"]["count"]) == int(jnew["opt"]["count"]) == 1


def test_q8_codes_match_reference():
    """Encode and decode of int8 moments against the reference's on the
    same f32 values: scales within 1 ulp, codes equal but for flips by
    one at a rounding boundary (``ROADMAP.md`` queue 3), at most 1 in
    1,000; decoding equal codes gives equal values."""
    rng = np.random.RandomState(5)
    n_codes = n_flips = 0
    for shape in [(300,), (4, 513), (3, 2), (2, 5, 256), (7, 255)]:
        x = (rng.standard_normal(shape) * rng.choice([1e-3, 1.0, 30.0])).astype(np.float32)
        jq, js = JA._q8_encode(jnp.asarray(x))
        pq, ps = PA._q8_encode(torch.from_numpy(x))
        assert pq.dtype == torch.int8 and pq.shape == shape
        np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=2e-7)
        diff = pq.numpy().astype(np.int32) - np.asarray(jq).astype(np.int32)
        assert np.abs(diff).max() <= 1
        n_codes, n_flips = n_codes + diff.size, n_flips + int(np.count_nonzero(diff))
        np.testing.assert_array_equal(
            PA._q8_decode(torch.from_numpy(np.array(jq)), torch.from_numpy(np.array(js)),
                          shape).numpy(),
            np.asarray(JA._q8_decode(jq, js, shape)))
    assert n_flips <= n_codes // 1000, (n_flips, n_codes)


@pytest.mark.parametrize("int8_moments", [False, True])
def test_checkpoints_cross_packages(tmp_path, int8_moments):
    """A checkpoint written by the reference loads in the port and a step
    from it lands on the reference's params (1e-5), and the reverse: the
    port's checkpoint loads in the reference (its ``Q8`` moments as
    ``{"q", "scale"}`` dicts, which ``train_state_from_jax`` takes back).
    With int8 moments a code that flips at a rounding boundary while the
    step re-encodes them turns into a param gap above 1e-5 (a moment
    decoded as 0 against one step of its scale, under ``eps`` = 1e-8);
    the bound there is the codes' own, at most 1 param in 1,000."""
    arch = "qwen3-0.6b"
    cfg = reduced_cfg(arch)
    kw = dict(global_batch=2, seq_len=16, total_steps=4, warmup_steps=0,
              int8_moments=int8_moments, remat=False)
    jm, jstate = _jax_state(cfg, arch, int8_moments)
    batch = _np_batch(cfg, 2, 16)
    jstep = jax.jit(JT.make_train_step(jm, JTrainConfig(**kw)))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    j1, _ = jstep(jstate, jbatch)
    j2, _ = jstep(j1, jbatch)
    pstep = make_train_step(port_model(cfg, arch), _tcfg(tmp_path, **kw))

    JC.save(str(tmp_path / "from_ref"), 1, j1)                 # reference -> port
    p1 = PC.load(str(tmp_path / "from_ref"), 1, device="cpu")
    assert isinstance(p1["opt"]["mu"]["embed"], Q8) == int8_moments
    p2, m2 = pstep(p1, _torch(batch))
    np.testing.assert_allclose(float(m2["loss"]), float(jstep(j1, jbatch)[1]["loss"]), rtol=1e-5)
    gaps = np.concatenate([np.abs(got - want).ravel() for got, want in zip(
        _port_params_like_jax(p2["params"]), _np_leaves(j2["params"]), strict=True)])
    n_off = int(np.count_nonzero(gaps > 1e-5))
    assert n_off <= (gaps.size // 1000 if int8_moments else 0), (n_off, gaps.max())

    PC.save(str(tmp_path / "from_port"), 2, p2)                # port -> reference
    back = JC.load(str(tmp_path / "from_port"), 2)
    for got, want in zip(_np_leaves(back["params"]),
                         _port_params_like_jax(p2["params"]), strict=True):
        np.testing.assert_array_equal(got, want)
    again = train_state_from_jax(back, device="cpu")
    assert _params_equal(again["params"], p2["params"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(again["opt"]),
                                                 tree_leaves(p2["opt"]), strict=True))
