"""The port's data parallelism (`coma_unet_tpu_torch/parallel/mesh.py`)
against the JAX package's mesh, on the CPU at f32.

One run of two gloo ranks (`tests/torch_port_dp_worker.py`, a process of
its own, killed at 180 s, whose ranks fork from it) runs every case on
the inputs written here and saves what each rank saw. Meanwhile the JAX
side computes its references: `make_sharded_train_step` on a `data=2`
mesh of the forced CPU devices, on the global batch of 4 (2 rows a rank,
so RnC carries signal), `make_sharded_eval_step`, and the train-mode
forward that gives each rank's rows their `batch_stats`. Its programs are
compiled at XLA's backend optimization level 0 (LLVM's, below the HLO
passes): a third less CPU time, the same results within the tolerances.
The single-process reference is the port's own step on the concatenated
batch (rank 0 runs it once the group is gone), which
`tests/test_torch_port_train.py` (RnC, and tCDS with the pred-space
triplet) holds to JAX's single-device `make_train_step`; JAX's
single-device step is not compiled again here.

Settings are the e2e parity test's (`tests/test_e2e_torch_parity.py`:
16^3, channels (4, 8, 16), 4 experts, f32, `pallas_convs=False`). The
flagship's parameters are the port's seeded init with seeded noise, the
regime of `tests/test_torch_port_train.py`, and the flax tree they map
from through `from_flax`. The batches compared with JAX are drawn clear
of the output ReLU's kink (`_draw`).

Tolerances: loss 1e-5 (relative above 1), grad_norm 1e-4; gradients per
leaf rtol 2e-3 with `tests/test_parallel.py`'s scale-aware atol
1e-4 x (1 + max|leaf|), or `tests/test_torch_port_train.py`'s 5e-6 of the
largest gradient where that is larger (the norm-fed conv biases, whose
true gradient is 0, carry f32 noise of that size on both sides); batch
statistics 1e-5; pred and the eval step's own metrics 1e-4, the metrics
against the JAX metric functions on the same pred 1e-5; after two AdamW
steps the ranks bit-identical and within rtol 2e-3 / atol 2e-5 of the
single-process port where both steps' gradients carry signal.
"""

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from coma_unet_tpu.config import LossConfig as JaxLossConfig  # noqa: E402
from coma_unet_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from coma_unet_tpu.metrics import roi_metrics as jax_roi_metrics  # noqa: E402
from coma_unet_tpu.metrics import voxel_metrics as jax_voxel_metrics  # noqa: E402
from coma_unet_tpu.models import ContraAttnUNet as FlaxContra  # noqa: E402
from coma_unet_tpu.parallel.mesh import (  # noqa: E402
    make_mesh as jax_make_mesh,
    make_sharded_eval_step as jax_sharded_eval_step,
    make_sharded_train_step as jax_sharded_train_step,
    replicate_state,
    shard_batch as jax_shard_batch,
)
from coma_unet_tpu.train import (  # noqa: E402
    create_train_state,
    make_optimizer as jax_make_optimizer,
)
from coma_unet_tpu.train.step import _apply as jax_apply  # noqa: E402
from coma_unet_tpu_torch import ContraAttnUNet, ModelConfig  # noqa: E402
from coma_unet_tpu_torch import data as pdata  # noqa: E402
from coma_unet_tpu_torch.convert import _port_key, from_flax  # noqa: E402
from coma_unet_tpu_torch.data import covariates as pcov  # noqa: E402
from coma_unet_tpu_torch.data.synthetic import make_synthetic_cohort  # noqa: E402
from coma_unet_tpu_torch.data.table import read_csv, write_rows  # noqa: E402
from coma_unet_tpu_torch.parallel.mesh import Mesh, shard_batch  # noqa: E402
from jax_fast import FAST  # noqa: E402
from test_torch_port_baselines import (  # noqa: E402
    ARGS,
    JAX_ONLY,
    TINY,
    _models,
    _variables,
)

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_port_dp_worker.py"
SPAWN_TIMEOUT_S = 180
B, S, R = 4, 16, 5
ROI_W = np.full((R,), 225.0, np.float32)
TCDS = dict(rnc=False, reg_weight=1.0, cds_weights=(0.0, 1.0, 4.0))
LOSS_TOL = 1e-5
FWD_TOL = dict(rtol=1e-4, atol=1e-4)
METRIC_TOL = dict(rtol=1e-5, atol=1e-6)
STATS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=2e-3, atol=2e-5)
KINK_MARGIN = 3e-5    # the port's output differs from the compiled JAX one's by <= 1.2e-5


def _batch(rng, triplet=False):
    def vol():
        v = rng.uniform(0.0, 1.0, size=(B, 1, S, S, S)).astype(np.float32)
        v[v < 0.2] = 0.0  # exercise the modulator's brain mask
        return v

    def covars():
        c = rng.normal(size=(B, 6)).astype(np.float32)
        c[:, 0] = [1.0, 0.0, 1.0, 0.0]  # abeta+ and abeta- prompts
        return c

    batch = {
        "mri": vol(), "covars": covars(),
        "roi_loc": rng.uniform(0.5, 2.0, size=(B, R)).astype(np.float32),
        "roi_std": rng.uniform(0.0, 0.5, size=(B, R)).astype(np.float32),
        "roi_compact": rng.integers(0, R + 1, size=(B, S, S, S)).astype(np.int32),
        "tau": rng.uniform(0.0, 2.0, size=(B, 1, S, S, S)).astype(np.float32),
        "valid_mask": np.ones(B, np.float32),
    }
    batch["abeta"] = batch["covars"][:, 0].copy()
    if triplet:
        for p in ("pos_", "neg_"):
            batch[p + "mri"] = vol()
            batch[p + "covars"] = covars()
            for k in ("roi_loc", "roi_std", "roi_compact"):
                batch[p + k] = batch[k]
    return batch


def _kink_margin(port, batch) -> float:
    """min |pre-ReLU output| of the port's train-mode forwards (the anchors
    and, in a triplet batch, the pos_* and neg_* partners): the distance of
    the batch from the output ReLU's kink."""
    seen = []
    hook = port.final_pred_head.register_forward_hook(
        lambda m, i, o: seen.append(float(o.detach().abs().min())))
    try:
        with torch.no_grad():
            for prefix in ("", "pos_", "neg_"):
                if prefix + "mri" in batch:
                    port.train()(*(torch.from_numpy(batch[prefix + k])
                                   for k in ARGS))
    finally:
        hook.remove()
    return min(seen)


def _draw(rng, port, triplet=False):
    """The next batch whose every output voxel lies KINK_MARGIN or more from
    the output ReLU's kink. Nearer, f32 rounding picks the ReLU's side: at
    the seed-0 draw one voxel's pre-ReLU output sat within 8e-6 of 0, and
    XLA's compiled gradient (every JAX step here is compiled) took the other
    side than JAX's own eager gradient and the port, moving gradients by up
    to 2.4 % of their leaf's largest (`ROADMAP.md` section 3). Such a batch
    tests rounding, not data parallelism."""
    for _ in range(32):
        batch = _batch(rng, triplet=triplet)
        if _kink_margin(port, batch) >= KINK_MARGIN:
            return batch
    raise AssertionError("no batch clear of the output ReLU's kink in 32 draws")


def _flagship_params(rng, batch, config=TINY):
    """The port's own seeded init with seeded numpy noise on every leaf (the
    regime of `tests/test_torch_port_train.py`, without compiling the flax
    init): the port's state dict and the flax `params` tree it maps from,
    each leaf placed through `from_flax`'s own key and layout map, for the
    ModelConfig fields `config` (TINY's by default)."""
    port = ContraAttnUNet(ModelConfig(**config), device="cpu",
                          generator=torch.Generator().manual_seed(0))
    state = {k: (v.numpy() + 0.05 * rng.normal(size=tuple(v.shape))).astype(
        np.float32) for k, v in port.state_dict().items()}
    shapes = jax.eval_shape(lambda k: FlaxContra(JaxModelConfig(
        **config, **JAX_ONLY)).init(k, *(jnp.asarray(batch[a]) for a in ARGS),
                                  train=False), jax.random.PRNGKey(0))["params"]

    def leaf(path, shape):
        index = np.arange(int(np.prod(shape))).reshape(shape)
        key, placed = _port_key(tuple(str(getattr(p, "key", p)) for p in path),
                                index, state)
        out = np.empty(index.size, np.float32)
        out[np.asarray(placed).reshape(-1)] = state[key].reshape(-1)
        return out.reshape(shape)

    params = jax.tree_util.tree_map_with_path(lambda p, s: leaf(p, s.shape),
                                              shapes)
    return {k: torch.from_numpy(v) for k, v in state.items()}, params


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _state(model, variables, batch):
    return create_train_state(
        model, jax_make_optimizer(1e-3), jax.random.PRNGKey(0),
        tuple(jnp.asarray(batch[k]) for k in ARGS), {"train": True},
        variables=variables)


def _run(fn, *args):
    """Lower and compile `fn` (jitted, at `FAST`), then run it; the results
    on the host."""
    return jax.device_get(fn.lower(*args).compile(compiler_options=FAST)(*args))


def _jax_sharded_step(model, state, batch, loss_config, mesh):
    """One step of JAX's `make_sharded_train_step` from the replicated
    `state` on `mesh`: its metrics and summed gradients."""
    step = jax_sharded_train_step(model, loss_config, mesh, donate=False,
                                  return_grads=True)
    return _run(step, state, jax_shard_batch(_jnp(batch), mesh),
                jnp.asarray(ROI_W), jax.random.PRNGKey(1))[1]


def _jax_pmean_stats(model, variables, batch):
    """`jax.lax.pmean` of the `batch_stats` that each rank's rows give in
    JAX's train-mode forward (the step's own `_apply`): what a data=2
    shard_map step keeps."""
    halves = [_jnp({k: v[i:i + B // 2] for k, v in batch.items()})
              for i in (0, B // 2)]
    forward = jax.jit(lambda v, h: jax_apply(
        model, v["params"], v["batch_stats"], h, "", True,
        jax.random.PRNGKey(1), True)[1])
    compiled = forward.lower(variables, halves[0]).compile(compiler_options=FAST)
    stats = [jax.device_get(compiled(variables, h)) for h in halves]
    return jax.tree.map(lambda a, b: (np.asarray(a) + np.asarray(b)) / 2, *stats)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(0)
    jcfg = JaxModelConfig(**TINY, **JAX_ONLY)
    flax_model = FlaxContra(jcfg)
    flagship, params = _flagship_params(rng, _batch(np.random.default_rng(1)))
    variables = {"params": params}
    port = ContraAttnUNet(ModelConfig(**TINY), device="cpu")
    assert all(torch.equal(v, flagship[k])
               for k, v in from_flax(params, port).items())
    port.load_state_dict(flagship)
    batch, batch2 = _draw(rng, port), _batch(rng)
    tcds_batch = _draw(rng, port, triplet=True)
    # unequal valid counts per rank: rank 0 holds 2 valid rows, rank 1 one
    tcds_batch["valid_mask"] = np.asarray([1, 1, 1, 0], np.float32)
    bn_flax, bn_port, _ = _models("AttnUNET", norm="batch")
    bn_batch = _batch(rng)
    bn_vars = _variables(bn_flax, rng,
                         *(jnp.asarray(bn_batch[k]) for k in ARGS), train=False)
    inputs = dict(model=TINY, flagship=flagship, batch=batch, batch2=batch2,
                  tcds_batch=tcds_batch, tcds_loss=TCDS,
                  bn_model=dict(TINY, norm="batch"),
                  bn=from_flax(bn_vars["params"], bn_port, bn_vars["batch_stats"]),
                  bn_batch=bn_batch, roi_w=ROI_W, num_rois=R)
    torch.save(inputs, str(out / "inputs.pt"))

    t0 = time.monotonic()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                       if p]))
    proc = subprocess.Popen(
        [sys.executable, str(WORKER), str(out / "inputs.pt"), str(out)],
        cwd=str(out), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    try:
        mesh = jax_make_mesh(data=2)
        eval_batch = {k: v for k, v in batch.items() if k != "valid_mask"}
        sstate = replicate_state(_state(flax_model, variables, batch), mesh)
        want = {
            "rnc": _jax_sharded_step(flax_model, sstate, batch, JaxLossConfig(),
                                     mesh),
            "tcds": _jax_sharded_step(flax_model, sstate, tcds_batch,
                                      JaxLossConfig(**TCDS), mesh),
            "eval": _run(jax_sharded_eval_step(flax_model, mesh, R), sstate,
                         jax_shard_batch(_jnp(eval_batch), mesh)),
            "bn": _jax_pmean_stats(bn_flax, bn_vars, bn_batch),
        }
        try:
            log, _ = proc.communicate(
                timeout=max(1.0, SPAWN_TIMEOUT_S - (time.monotonic() - t0)))
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            log, _ = proc.communicate()
            pytest.fail(f"the two ranks did not finish in {SPAWN_TIMEOUT_S} s:\n"
                        f"{log[-3000:]}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    assert proc.returncode == 0, log[-5000:]
    ranks = [torch.load(str(out / f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    single = ranks[0]["single"]
    return dict(want=want, ranks=ranks, port=port, bn_port=bn_port,
                bn_vars=bn_vars, batch=batch,
                single=dict(rnc=single["rnc"][0], tcds=single["tcds"]),
                single_params=single["params"],
                single_grads=[s["grads"] for s in single["rnc"]])


def _close(got, want, tol=LOSS_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= tol * np.maximum(1.0, np.abs(want))), (
        got, want)


def _reference(run, case, ref):
    """The metrics and the port-keyed gradients of `case`'s reference step:
    JAX's sharded step, or the single-process port on the global batch."""
    if ref == "single":
        return run["single"][case]["metrics"], run["single"][case]["grads"]
    aux = run["want"][case]
    return aux, from_flax(aux["grads"], run["port"])


def _grad_misses(port, got, want):
    """The parameters whose gradient misses the reference's (port-keyed):
    per leaf rtol 2e-3, atol the larger of 1e-4 x (1 + max|leaf|) and
    5e-6 x the largest gradient (a missing gradient reads 0)."""
    floor = 5e-6 * max(float(w.abs().max()) for w in want.values())
    misses = []
    for name, p in port.named_parameters():
        g = got[name] if got[name] is not None else torch.zeros_like(p)
        w = (want[name] if name in want else torch.zeros_like(p)).numpy()
        atol = max(1e-4 * (1.0 + float(np.abs(w).max())), floor)
        if not np.allclose(g.numpy(), w, rtol=2e-3, atol=atol):
            misses.append(name)
    return misses


def _value(x):
    return x.numpy() if isinstance(x, torch.Tensor) else x


@pytest.mark.parametrize("ref", ["sharded", "single"])
def test_rnc_step_matches_jax(run, ref):
    """The 2-rank RnC step against JAX's `make_sharded_train_step` on a
    data=2 mesh, and against the single-process port step on the global
    batch (JAX's `make_train_step` there, as `tests/test_torch_port_train.py`
    holds it): loss, per-sample gen_loss, the RnC term, grad_norm and every
    gradient; both ranks report the same metrics."""
    aux, want = _reference(run, "rnc", ref)
    got = [r["rnc"]["metrics"] for r in run["ranks"]]
    for name in ("loss", "gen_loss", "tcds_loss", "pred_space_loss"):
        _close(got[0][name].numpy(), _value(aux[name]))
    assert abs(float(aux["tcds_loss"])) > 1e-3  # RnC is live at b=4
    _close(got[0]["grad_norm"].numpy(), _value(aux["grad_norm"]), tol=1e-4)
    for name, value in got[0].items():
        assert torch.equal(value, got[1][name]), name
    assert not _grad_misses(run["port"], run["ranks"][0]["rnc"]["grads"], want)


@pytest.mark.parametrize("ref", ["sharded", "single"])
def test_tcds_step_with_unequal_valid_rows_matches_jax(run, ref):
    """tCDS with the pred-space triplet (`reg_weight` 1, cds_weights
    (0, 1, 4)) and `valid_mask` [1, 1, 1, 0]: the batch-coupled means are
    taken over the global valid rows; loss, the two coupled terms and every
    gradient against JAX's sharded step and the single-process port."""
    aux, want = _reference(run, "tcds", ref)
    got = run["ranks"][0]["tcds"]["metrics"]
    for name in ("loss", "gen_loss", "tcds_loss", "pred_space_loss"):
        _close(got[name].numpy(), _value(aux[name]))
    assert float(got["pred_space_loss"]) > 0.0
    assert got["valid_mask"].tolist() == [1.0, 1.0, 1.0, 0.0]
    assert not _grad_misses(run["port"], run["ranks"][0]["tcds"]["grads"], want)


def test_batch_norm_running_stats_are_the_jax_pmean(run):
    """AttnUNET with batch norm: each rank normalizes with its own rows'
    statistics, and the running mean and var after the step are the mean
    over the ranks of JAX's per-shard `batch_stats` (`jax.lax.pmean`, the
    JAX sharded step's rule; that step cannot run a baseline itself, see
    `test_jax_sharded_step_cannot_train_a_baseline`), the same on both
    ranks."""
    want = from_flax(run["bn_vars"]["params"], run["bn_port"], run["want"]["bn"])
    got = [r["bn"]["stats"] for r in run["ranks"]]
    assert got[0] and set(got[0]) == set(got[1])
    old = from_flax(run["bn_vars"]["params"], run["bn_port"],
                    run["bn_vars"]["batch_stats"])
    for key, value in got[0].items():
        assert torch.equal(value, got[1][key]), key
        assert not torch.equal(value, old[key]), key  # the statistics moved
        np.testing.assert_allclose(value.numpy(), want[key].numpy(), **STATS_TOL,
                                   err_msg=key)


def test_sharded_eval_matches_jax(run):
    """The 2-rank eval step against JAX's `make_sharded_eval_step`: `pred`
    and every per-sample voxel and ROI metric of the global batch, on both
    ranks; the metrics also against the JAX metric functions on the port's
    `pred`."""
    jpred, jvox, jroi = run["want"]["eval"]
    (pred, vox, roi), (pred1, vox1, roi1) = (r["eval"] for r in run["ranks"])
    assert tuple(pred.shape) == (B, 1, S, S, S)
    assert torch.equal(pred, pred1)
    np.testing.assert_allclose(pred.numpy(), jpred, **FWD_TOL)
    batch = run["batch"]
    p, tau = jnp.asarray(pred.numpy()), jnp.asarray(batch["tau"])
    same = (jax_voxel_metrics(p, tau),
            jax_roi_metrics(p, tau, jnp.asarray(batch["roi_compact"]), R))
    for got, other, want, own in ((vox, vox1, same[0], jvox),
                                  (roi, roi1, same[1], jroi)):
        assert set(got) == set(want) == set(own) == set(other)
        for key in want:
            assert got[key].shape[0] == B, key
            assert torch.equal(got[key], other[key]), key
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                       **METRIC_TOL, err_msg=key)
            if key != "abs_rel_vol":
                np.testing.assert_allclose(got[key].numpy(), np.asarray(own[key]),
                                           **FWD_TOL, err_msg=key)


def test_two_adamw_steps_keep_the_ranks_identical(run):
    got = [r["adamw"] for r in run["ranks"]]
    assert set(got[0]) == set(got[1])
    for name, value in got[0].items():
        assert torch.equal(value, got[1][name]), name


def test_two_adamw_steps_match_the_single_process_port(run):
    """After two AdamW steps the parameters are within tolerance of the
    single-process port's on the concatenated batches, where both steps'
    gradients are well above the f32 noise floor (AdamW moves an element by
    about lr x sign(g), so noise-level gradients are not comparable)."""
    single, grads = run["single_params"], run["single_grads"]
    got = run["ranks"][0]["adamw"]
    n_signal = 0
    for name, p in single.items():
        if name not in grads[0]:
            continue
        signal_ = np.ones(tuple(p.shape), bool)
        for g in grads:
            scale = max(1.0, max(float(v.abs().max()) for v in g.values()))
            signal_ &= (g[name].abs() > 1e-4 * scale).numpy()
        if not signal_.any():
            continue
        n_signal += 1
        np.testing.assert_allclose(got[name].numpy()[signal_],
                                   p.numpy()[signal_], **PARAM_TOL,
                                   err_msg=name)
    assert n_signal >= 20


def test_a_gather_without_the_cross_rank_sum_fails_the_rnc_parity(run):
    """The same RnC step with a gather whose backward keeps only this rank's
    cotangent under-counts every coupled gradient by the factor 2: the
    gradient comparison of `test_rnc_step_matches_jax` catches it."""
    misses = _grad_misses(run["port"], run["ranks"][0]["local"]["grads"],
                          _reference(run, "rnc", "sharded")[1])
    assert len(misses) >= 10, misses
    assert any(m.startswith(("proj", "final_proj")) for m in misses)


def test_jax_sharded_step_cannot_train_a_baseline():
    """A fault of the reference: the JAX `make_sharded_train_step` reads
    `outs.projections[-1]` for RnC without the single-device step's
    generative-only branch, so a model without projection heads (any
    baseline) fails at trace time. The port's sharded step trains it on the
    generative term, as the single-device steps do (`bn` case above)."""
    bn_flax, _, _ = _models("AttnUNET", norm="batch")
    rng = np.random.default_rng(1)
    batch = _batch(rng)
    variables = _variables(bn_flax, rng, *(jnp.asarray(batch[k]) for k in ARGS),
                           train=False)
    mesh = jax_make_mesh(data=2)
    step = jax_sharded_train_step(bn_flax, JaxLossConfig(), mesh, donate=False)
    state = replicate_state(_state(bn_flax, variables, batch), mesh)
    with pytest.raises(IndexError):
        step.lower(state, jax_shard_batch(_jnp(batch), mesh),
                   jnp.asarray(ROI_W), jax.random.PRNGKey(1))


@pytest.mark.parametrize("rank", [0, 1])
def test_shard_batch_takes_the_ranks_rows(rank):
    mesh = Mesh(rank=rank, size=2, device=torch.device("cpu"))
    batch = {"mri": torch.arange(8).reshape(4, 2), "valid_mask": np.arange(4),
             "sample_ids": ["a", "b", "c", "d"], "scalar": 3.0}
    got = shard_batch(batch, mesh)
    rows = slice(2 * rank, 2 * rank + 2)
    assert torch.equal(got["mri"], batch["mri"][rows])
    assert got["valid_mask"].tolist() == batch["valid_mask"][rows].tolist()
    assert got["sample_ids"] == batch["sample_ids"][rows] and got["scalar"] == 3.0
    with pytest.raises(ValueError, match="does not split"):
        shard_batch({"mri": torch.zeros(3)}, mesh)


@pytest.mark.parametrize("with_triplets", [False, True])
def test_sharded_loader_reads_the_single_process_rows(tmp_path, with_triplets):
    """Two shuffled passes of 7 subjects at b=4 (the last batch of each
    wrap-padded): the ranks' loaders, concatenated in rank order, give the
    single-process loader's batches, `valid` and the triplet partners
    (pos_*/neg_*) included, and each rank reads only its rows."""
    cohort = make_synthetic_cohort(str(tmp_path / "cohort"))
    rows = read_csv(cohort["lookup"]).rows()[:7]
    lookup = str(tmp_path / "seven.csv")
    write_rows(lookup, rows)

    def loader(shard):
        ds = pdata.PredictedMetaTauDataset(
            lookup, pcov.CovariateTable(cohort["cov"]),
            pcov.QuartileTable(cohort["quart"]),
            meta_tau_table=pcov.PredictionTable(cohort["preds"]),
            pad_dims=(S, S, S), seed=3)
        reads = []
        load = ds.load
        ds.load = lambda i, partners=None: (reads.append(i), load(i, partners))[1]
        ld = pdata.DataLoader(ds, 4, shuffle=True, seed=5, num_workers=2,
                              with_triplets=with_triplets, shard=shard)
        return ld, [b for _ in range(2) for b in ld], reads

    single, want, _ = loader((0, 1))
    parts = [loader((r, 2)) for r in range(2)]
    order = [i for e in range(2) for b in single._batches(e)[0] for i in b]
    assert len(want) == 4 and want[1]["valid"].tolist() == [True, True, True, False]
    for r, (_, got, reads) in enumerate(parts):
        assert sorted(reads) == sorted(i for k in range(0, len(order), 4)
                                       for i in order[k + 2 * r:k + 2 * r + 2])
    for k, w in enumerate(want):
        g0, g1 = parts[0][1][k], parts[1][1][k]
        assert set(g0) == set(w) == set(g1)
        if with_triplets:
            assert {"pos_mri", "neg_mri"} <= set(w)
        for key, value in w.items():
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(
                    np.concatenate([g0[key], g1[key]]), value, err_msg=key)
            else:
                assert list(g0[key]) + list(g1[key]) == list(value), key
