"""The port's spatial parallelism (`coma_unet_tpu_torch/parallel/spatial.py`)
against the JAX package's `make_spatial_infer_fn`, on the CPU at f32.

One subprocess (`tests/torch_port_sp_worker.py`, killed at 120 s) forks
the ranks of each case in turn, each rank holding a depth slab of one
volume, that run the port's `make_spatial_infer_fn`, and again with planted
faults: every halo read as zeros, each rank's own norm statistics left
unmerged, and a plan boundary moved off its multiple of 2^L. The cases:
N = 2 and N = 4 on 16^3 (even slabs); N = 3 on 16^3, uneven at every level
(slabs of 4, 8 and 4 planes, then 2/4/2 and 1/2/1); N = 2 on a volume of
depth 18, whose levels 18 -> 9 -> 5 do not halve (slabs of 8 and 10
planes, then 4/5 and 2/3: the last rank's upsample is cut by one plane).
Meanwhile JAX compiles its `make_spatial_infer_fn` on a
`make_mesh(data=1, spatial=N)` mesh (N = 2, 4) and a `make_mesh(data=3)`
mesh of the forced CPU devices, and its unsharded forward at depth 18, at
XLA's backend optimization level 0.

Settings are the e2e parity test's (`tests/test_e2e_torch_parity.py`:
16^3, channels (4, 8, 16), 4 experts, f32, `pallas_convs=False`), at b=1
as the spatial path runs; at N = 4 the bottom level's slabs are one plane.
The depth-18 case takes `prompt_shape` (18, 16, 16). The weights are the
port's seeded init with seeded noise and the flax tree they map to
(`test_torch_port_parallel._flagship_params`).

Tolerances: against JAX rtol 1e-4 and atol 1e-4 (the e2e forward's); against
the port's unsharded forward 1e-5 of max|out| (the sharded statistics are
merged in f64, the unsharded ones taken in f32); K4's two slab halves'
plain versions, merged over slabs, against the plain K4 on whole rows
1e-6; each planted fault must read above the limits.
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

from coma_unet_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from coma_unet_tpu.models import ContraAttnUNet as FlaxContra  # noqa: E402
from coma_unet_tpu.parallel.mesh import (  # noqa: E402
    make_mesh as jax_make_mesh,
    make_spatial_infer_fn as jax_spatial_infer_fn,
)
from coma_unet_tpu_torch import ContraAttnUNet, ModelConfig, ops  # noqa: E402
from coma_unet_tpu_torch.ops.norm_act import mean_rstd  # noqa: E402
from coma_unet_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from coma_unet_tpu_torch.parallel.spatial import (  # noqa: E402
    Slab,
    make_spatial_infer_fn,
    plan_slabs,
)
from jax_fast import fast  # noqa: E402
from test_torch_port_baselines import ARGS, JAX_ONLY, TINY  # noqa: E402
from test_torch_port_parallel import _batch, _flagship_params  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_port_sp_worker.py"
SPAWN_TIMEOUT_S = 120
WORLDS = (2, 4)
UNEVEN = 3            # ranks on 16^3: slabs of 4, 8 and 4 planes
ODD = "depth18"       # 2 ranks on [1, 1, 18, 16, 16]: levels 18 -> 9 -> 5
ODD_DEPTH = 18
CASES = WORLDS + (UNEVEN, ODD)
MISALIGNED = (0, 6, 12)  # UNEVEN's plan with boundaries off their multiples of 4
JAX_TOL = dict(rtol=1e-4, atol=1e-4)
PORT_TOL = 1e-5       # of max|out|
MERGE_TOL = 1e-6
FAULTS = ("zero_halo", "unmerged")


def _excess(got, want, rtol, atol) -> float:
    """max |got - want| in units of the allowance atol + rtol |want|: <= 1
    passes."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want) / (atol + rtol * np.abs(want))))


def _odd_batch(rng):
    """A b=1 batch of `_batch`'s kinds at depth ODD_DEPTH."""
    batch = _batch(rng)
    shape = (1, 1, ODD_DEPTH) + batch["mri"].shape[3:]
    mri = rng.uniform(0.0, 1.0, size=shape).astype(np.float32)
    mri[mri < 0.2] = 0.0
    compact = rng.integers(0, batch["roi_loc"].shape[1] + 1,
                           size=(1,) + shape[2:]).astype(np.int32)
    return dict({k: batch[k][:1] for k in ARGS}, mri=mri, roi_compact=compact)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("sp")
    rng = np.random.default_rng(0)
    batch = {k: v[:1] for k, v in _batch(np.random.default_rng(1)).items()}
    state, params = _flagship_params(rng, batch)
    odd_cfg = dict(TINY, prompt_shape=(ODD_DEPTH,) + TINY["prompt_shape"][1:])
    odd_batch = _odd_batch(np.random.default_rng(2))
    odd_state, odd_params = _flagship_params(rng, odd_batch, odd_cfg)
    port = ContraAttnUNet(ModelConfig(**TINY), device="cpu")
    port.load_state_dict(state)
    odd_port = ContraAttnUNet(ModelConfig(**odd_cfg), device="cpu")
    odd_port.load_state_dict(odd_state)
    args = tuple(batch[k] for k in ARGS)
    odd_args = tuple(odd_batch[k] for k in ARGS)
    even = dict(model=TINY, state=state, args=args)
    cases = [dict(even, name=f"n{n}", world=n, faults=FAULTS) for n in WORLDS]
    cases.append(dict(even, name=f"n{UNEVEN}", world=UNEVEN,
                      faults=FAULTS + ("misaligned",), misaligned=MISALIGNED))
    cases.append(dict(model=odd_cfg, state=odd_state, args=odd_args, name=ODD,
                      world=2, faults=()))
    torch.save(cases, str(out / "inputs.pt"))

    t0 = time.monotonic()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                       if p]))
    proc = subprocess.Popen(
        [sys.executable, str(WORKER), str(out / "inputs.pt"), str(out)],
        cwd=str(out), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    try:
        flax_model = FlaxContra(JaxModelConfig(**TINY, **JAX_ONLY))
        jargs = [{"params": params}] + [jnp.asarray(a) for a in args]
        want = {}
        meshes = {n: jax_make_mesh(data=1, spatial=n) for n in WORLDS}
        meshes[UNEVEN] = jax_make_mesh(data=UNEVEN)
        for n, mesh in meshes.items():
            infer = fast(jax_spatial_infer_fn(flax_model, mesh))
            want[n] = np.asarray(jax.device_get(infer(*jargs)))
        odd_flax = FlaxContra(JaxModelConfig(**odd_cfg, **JAX_ONLY))
        forward = fast(jax.jit(lambda v, *a: odd_flax.apply(
            v, *a, train=False, with_projections=False).out))
        want[ODD] = np.asarray(jax.device_get(forward(
            {"params": odd_params}, *(jnp.asarray(a) for a in odd_args))))
        with torch.no_grad():
            single = {n: port(*(torch.from_numpy(a) for a in args),
                              with_projections=False).out.numpy()
                      for n in WORLDS + (UNEVEN,)}
            single[ODD] = odd_port(*(torch.from_numpy(a) for a in odd_args),
                                   with_projections=False).out.numpy()
        try:
            log, _ = proc.communicate(
                timeout=max(1.0, SPAWN_TIMEOUT_S - (time.monotonic() - t0)))
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            log, _ = proc.communicate()
            pytest.fail(f"the ranks did not finish in {SPAWN_TIMEOUT_S} s:\n"
                        f"{log[-3000:]}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    assert proc.returncode == 0, log[-5000:]
    ranks = {case_id: [torch.load(str(out / f"{c['name']}_rank{r}.pt"),
                                  weights_only=False) for r in range(c["world"])]
             for case_id, c in zip(CASES, cases)}
    return dict(want=want, single=single, ranks=ranks, port=port, args=args)


@pytest.mark.parametrize("n", WORLDS + (UNEVEN,))
def test_spatial_forward_matches_jax(run, n):
    """N gloo ranks, each on its depth slab, against JAX's GSPMD forward
    (N = 2, 4 on a data=1 x spatial=N mesh; N = 3, uneven, on data=3):
    rank 0 assembles `out`; the others return None."""
    ranks = run["ranks"][n]
    got = ranks[0]["sound"]["out"]
    assert all(r["sound"]["out"] is None for r in ranks[1:])
    assert tuple(got.shape) == (1, 1, 16, 16, 16)
    assert _excess(got.numpy(), run["want"][n], **JAX_TOL) <= 1.0


def test_odd_depth_unsharded_port_matches_jax(run):
    """At depth 18 (levels 18 -> 9 -> 5, the upsample 5 -> 10 cut to 9) the
    port's unsharded forward, which the sharded one is held to, against
    JAX's."""
    single = run["single"][ODD]
    assert single.shape == (1, 1, ODD_DEPTH, 16, 16)
    assert _excess(single, run["want"][ODD], **JAX_TOL) <= 1.0


@pytest.mark.parametrize("n", CASES)
def test_spatial_forward_matches_the_unsharded_port(run, n):
    got = run["ranks"][n][0]["sound"]["out"].numpy()
    single = run["single"][n]
    assert got.shape == single.shape
    err = float(np.abs(got - single).max())
    assert err <= PORT_TOL * float(np.abs(single).max()), err


@pytest.mark.parametrize("n", WORLDS + (UNEVEN,))
@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_are_caught(run, fault, n):
    """Halos read as zeros, or each rank's own statistics unmerged: the
    result must miss JAX's by more than the 1e-4 limit."""
    got = run["ranks"][n][0][fault]["out"].numpy()
    assert _excess(got, run["want"][n], **JAX_TOL) > 1.0


def test_a_misaligned_plan_is_caught(run):
    """The 3-rank plan with its boundaries moved from (4, 12) to (6, 12),
    off their multiples of 2^L = 4, with the guard against a depth crop on
    a rank other than the last lifted (the moved boundary gives rank 0 an
    odd slab at level 1): the stride-2 windows then leave the unsharded
    grid, and the result must miss both limits."""
    got = run["ranks"][UNEVEN][0]["misaligned"]["out"].numpy()
    single = run["single"][UNEVEN]
    assert got.shape == single.shape
    assert float(np.abs(got - single).max()) > PORT_TOL * float(np.abs(single).max())
    assert _excess(got, run["want"][UNEVEN], **JAX_TOL) > 1.0


@pytest.mark.parametrize("n", CASES)
def test_every_rank_runs_the_slab_halves_not_k4(run, n):
    """On each rank the sharded forward ran the plain versions of K1, K2,
    K3 and K4's two slab halves, and never the whole-row K4."""
    for rank in run["ranks"][n]:
        plain = rank["sound"]["plain"]
        assert all(plain.get(f, 0) > 0 for f in ("s1", "s2", "t2") + ops.SLAB_FAMILIES), plain
        assert plain.get("norm_act", 0) == 0, plain


@pytest.mark.parametrize("n", CASES)
def test_statistics_bit_identical_on_every_rank(run, n):
    """Every norm's merged (mean, rstd), in call order, is the same bits on
    every rank: each merges the same gathered buffer in rank order, whatever
    the slabs' counts."""
    seen = [r["sound"]["stats"] for r in run["ranks"][n]]
    assert len(seen[0]) > 0
    for other in seen[1:]:
        assert len(other) == len(seen[0])
        assert all(torch.equal(a, b) for a, b in zip(other, seen[0]))


@pytest.mark.parametrize("act,film", [("none", False), ("relu", True),
                                      ("leakyrelu", True), ("prelu", True)])
def test_slab_halves_merge_to_k4(act, film):
    """`norm_stats_plain` on each of 4 depth slabs, `merge_partials` in slab
    order and `norm_apply_plain` with the merged statistics give the plain
    K4 on the whole rows within 1e-6."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy((2.0 + rng.normal(size=(2, 3, 8, 5, 6))).astype(np.float32))
    alpha = torch.tensor([0.25])
    scale = shift = None
    if film:
        scale = torch.from_numpy(rng.uniform(0.5, 1.5, (2, 3)).astype(np.float32))
        shift = torch.from_numpy(rng.normal(size=(2, 3)).astype(np.float32))
    parts = torch.stack([ops.norm_stats(s) for s in x.split(2, dim=2)])
    stats = mean_rstd(ops.merge_partials(parts))
    got = ops.norm_apply(x, stats, alpha, act, scale, shift)
    want = ops.norm_act_plain(x, alpha, act, scale, shift)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=MERGE_TOL)


def test_uneven_slab_statistics_merge_to_k4():
    """Slabs of 1, 4 and 3 planes (unequal counts): their partials merged
    in slab order give the plain K4 within 1e-6."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy((2.0 + rng.normal(size=(2, 3, 8, 5, 6))).astype(np.float32))
    parts = [ops.norm_stats(s) for s in x.split([1, 4, 3], dim=2)]
    slots = torch.zeros((3,) + tuple(parts[0].shape), dtype=torch.float64)
    for i, p in enumerate(parts):
        slots[i] = p
    stats = mean_rstd(ops.merge_partials(slots))
    got = ops.norm_apply(x, stats, None, "none")
    want = ops.norm_act_plain(x, None, "none")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=MERGE_TOL)


@pytest.mark.parametrize("depth,world,sizes,starts", [
    (216, 2, (216, 108, 54, 27, 14), (0, 112)),
    (128, 3, (128, 64, 32, 16, 8), (0, 48, 80)),
    (128, 8, (128, 64, 32, 16, 8), tuple(range(0, 128, 16))),
    (216, 14, (216, 108, 54, 27, 14), None),
    (16, 3, (16, 8, 4), (0, 4, 12)),
])
def test_plan_slabs_tiles_every_level(depth, world, sizes, starts):
    """The level sizes are the stride-2 convs' ceil(D / 2); each rank
    starts at a multiple of 2^L; at each level the slabs tile the depth in
    rank order, none empty, every boundary is twice the next level's and
    every slab but the last is even above the deepest level."""
    strides = (2,) * (len(sizes) - 1)
    plan = plan_slabs(depth, strides, world)
    assert plan.sizes == sizes and plan.world == world
    if starts is not None:
        assert plan.starts == starts
    deepest = len(sizes) - 1
    assert all(b % 2 ** deepest == 0 for b in plan.starts)
    for level, size in enumerate(sizes):
        slabs = [plan.planes(r, level) for r in range(world)]
        assert slabs[0].start == 0 and slabs[-1].stop == size
        assert all(a.stop == b.start for a, b in zip(slabs, slabs[1:]))
        assert all(s.stop > s.start for s in slabs)
        if level < deepest:
            assert all((s.stop - s.start) % 2 == 0 for s in slabs[:-1])
            nxt = [plan.planes(r, level + 1) for r in range(world)]
            assert all(s.start == 2 * t.start for s, t in zip(slabs, nxt))
    if (depth, world) == (216, 2):
        assert [plan.planes(r, 3) for r in range(2)] == [slice(0, 14), slice(14, 27)]


def test_only_the_last_rank_crops_depth():
    """The decoder's depth crop: the last rank's odd slab loses one plane;
    on any other rank, or by more than one plane, it raises."""
    plan = plan_slabs(18, (2, 2), 2)
    first = Slab(Mesh(0, 2, torch.device("cpu")), plan)
    last = Slab(Mesh(1, 2, torch.device("cpu")), plan)
    last.check_crop(6, 5)
    for slab, have, want in ((first, 6, 5), (last, 7, 5)):
        with pytest.raises(RuntimeError, match="only the last rank"):
            slab.check_crop(have, want)


def test_an_uneven_plan_is_refused_before_any_rank_starts(run):
    """At 16^3 with 3 levels (16, 8, 4 planes), 5 ranks cannot each hold a
    plane of level 2: the plan and the infer function refuse it with
    ValueError before any collective (here there is no process group at
    all); 4 ranks, and uneven 3, plan; a halo wider than the slab is
    refused too."""
    with pytest.raises(ValueError, match="level 2 holds 4 planes"):
        plan_slabs(16, (2, 2), 5)
    assert plan_slabs(16, (2, 2), 4).planes(3, 2) == slice(3, 4)
    assert plan_slabs(16, (2, 2), 3).planes(1, 2) == slice(1, 3)
    infer = make_spatial_infer_fn(run["port"], Mesh(0, 5, torch.device("cpu")))
    with pytest.raises(ValueError, match="level 2 holds 4 planes"):
        infer(*run["args"])
    with pytest.raises(ValueError, match="wider than a slab"):
        Slab(Mesh(0, 2, torch.device("cpu")), plan_slabs(16, (2, 2), 2)).halo(
            torch.zeros(1, 1, 1, 2, 2), 2, 0)
