"""The tCDS data path of the port against the JAX package's, on the CPU:
the triplet datasets' partners, items and batches, the other datasets
(`CombinedVolumeDataset`, `A4VolumeDataset`), `CustomSampler`, the split
orchestration, and two epochs of the training loop with `loss.rnc` false,
at f32 on a 16^3 synthetic cohort (channels (4, 8, 16), 4 experts).

The JAX side is indexed in order: its loader maps `__getitem__` over a
thread pool, so it draws partners in the threads' order and is not
reproducible with more than one worker. The port draws a pass's partners
in the pass's index order before it reads any, so its batches equal the
JAX dataset's indexed in that order, with 1 and with 4 workers.

The loop compares every step's loss (rel 1e-5), each epoch's average, the
validation CSVs and the pos_metrics / neg_metrics CSVs (rel 1e-4; the
correlations abs 1e-4), the tolerances of `test_torch_port_loop.py`, at its
learning rate of 1e-5.
"""

import functools
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402

import coma_unet_tpu.config as jconfig  # noqa: E402
import coma_unet_tpu.train.loop as jloop  # noqa: E402
from coma_unet_tpu import data as jdata  # noqa: E402
from coma_unet_tpu.data import covariates as jcov  # noqa: E402
from coma_unet_tpu.data import orchestration as jorch  # noqa: E402
from coma_unet_tpu.models import ContraAttnUNet as FlaxContra  # noqa: E402
from coma_unet_tpu.train import make_eval_step as j_make_eval_step  # noqa: E402
from coma_unet_tpu.train import make_train_step as j_make_train_step  # noqa: E402
from coma_unet_tpu.train.recorder import MetricRecorder as JRecorder  # noqa: E402
from coma_unet_tpu.train.state import create_train_state as j_create_state  # noqa: E402

import coma_unet_tpu_torch.config as pconfig  # noqa: E402
import coma_unet_tpu_torch.train.loop as ploop  # noqa: E402
from coma_unet_tpu_torch import ContraAttnUNet  # noqa: E402
from coma_unet_tpu_torch import data as pdata  # noqa: E402
from coma_unet_tpu_torch.cli import main as cli_main  # noqa: E402
from coma_unet_tpu_torch.convert import from_flax  # noqa: E402
from coma_unet_tpu_torch.data import covariates as pcov  # noqa: E402
from coma_unet_tpu_torch.data import datasets as pdatasets  # noqa: E402
from coma_unet_tpu_torch.data import orchestration as porch  # noqa: E402
from coma_unet_tpu_torch.data.synthetic import make_synthetic_cohort  # noqa: E402
from coma_unet_tpu_torch.data.table import read_csv, write_rows  # noqa: E402
from coma_unet_tpu_torch.train.recorder import MetricRecorder as PRecorder  # noqa: E402
from jax_fast import fast  # noqa: E402

S = 16
MODEL = dict(channels=(4, 8, 16), strides=(2, 2, 2), latent_spaces=(32,) * 3,
             prompt_shape=(S, S, S), num_experts=4, compute_dtype="float32",
             pallas_convs=False, packed_level=False, remat=False)
R = len(jconfig.ROI_INDICES)
LR = 1e-5
STEP_TOL, CSV_TOL, CORR_ATOL = 1e-5, 1e-4, 1e-4
KINDS = ("contrastive", "true_negatives", "cluster", "regression_cluster",
         "regression_contrastive")


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """8 subjects: the (abeta, quartile) cells of subjects i and i + 4 are
    one; `seven` leaves subject 7's cell with one member, whose positive is
    the anchor itself; `train` holds two cells of two."""
    root = tmp_path_factory.mktemp("tcds")
    c = make_synthetic_cohort(str(root / "cohort"))
    rows = read_csv(c["lookup"]).rows()
    c["seven"] = str(root / "seven.csv")
    write_rows(c["seven"], rows[:7])
    c["train"] = str(root / "train.csv")
    write_rows(c["train"], [rows[i] for i in (0, 1, 4, 5)])
    c["test"] = str(root / "test.csv")
    write_rows(c["test"], rows[4:])
    c["out"] = str(root)
    return c


def _same(a, b, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (where, sorted(a), sorted(b))
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b or (a != a and b != b), (where, a, b)


def _tables(c, port):
    mod = pcov if port else jcov
    return (mod.CovariateTable(c["cov"]), mod.QuartileTable(c["quart"]),
            mod.PredictionTable(c["preds"]))


def _dataset(c, port, kind, seed, lookup=None):
    d = pdata if port else jdata
    cov, quart, preds = _tables(c, port)
    kw = dict(pad_dims=(S, S, S), seed=seed)
    lookup = lookup or c["seven"]
    if kind in ("contrastive", "true_negatives"):
        return d.ContrastiveVolumeDataset(
            lookup, cov, quart, true_negatives=kind == "true_negatives", **kw)
    if kind == "cluster":
        return d.ClusterVolumeDataset(lookup, cov, quart, **kw)
    return d.PredictedMetaTauDataset(lookup, cov, quart, meta_tau_table=preds,
                                     mode=kind.split("_")[1], **kw)


def _negative(item):
    """The negative that the JAX `collate` takes from an item."""
    return item.get("neg") or (item["negs"][0] if item.get("negs") else item["pos"])


_COHORTS: dict = {}


@functools.lru_cache(maxsize=None)
def _jax_passes(root, kind, seed, order):
    """The JAX dataset indexed in `order`: each item's partner ids and the
    triplet batches its `collate` makes of them, two at a time (shared by
    the worker counts)."""
    cohort = _COHORTS[root]
    ds = _dataset(cohort, False, kind, seed)
    items = [ds[i] for i in order]
    ids = [(it["pos"]["sample_id"],
            [n["sample_id"] for n in (it["negs"] if "negs" in it else [it["neg"]])])
           for it in items]
    preds = _tables(cohort, False)[2]
    batches = [jdata.collate(items[k:k + 2], preds, with_triplets=True)
               for k in range(0, len(items), 2)]
    return ids, batches


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_triplet_batches_match_jax(cohort, kind, seed, workers):
    """Two shuffled passes of 7 subjects at b=2 (the last batch of each
    wrap-padded): the port's batches, pos_* and neg_* included, equal the
    JAX dataset's items indexed in the passes' order, collated by JAX."""
    _COHORTS[cohort["root"]] = cohort
    ds = _dataset(cohort, True, kind, seed)
    preds = _tables(cohort, True)[2]
    loader = pdata.DataLoader(ds, 2, predictions=preds, with_triplets=True,
                              shuffle=True, seed=seed, num_workers=workers)
    order = tuple(i for e in range(2) for b in loader._batches(e)[0] for i in b)
    got = [b for _ in range(2) for b in loader]
    ids, want = _jax_passes(cohort["root"], kind, seed, order)
    assert len(got) == len(want) == 8
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.pop("valid").tolist() == ([True, False] if k % 4 == 3 else [True, True])
        assert {n for n in g if n.startswith(("pos_", "neg_"))} == {
            p + n for p in ("pos_", "neg_") for n in
            ("mri", "tau", "roi_compact", "covars", "abeta", "roi_loc", "roi_std")}
        _same(g, w, f"batch {k}")
    # the partners drawn, every negative of a cluster item included
    fresh = _dataset(cohort, True, kind, seed)
    drawn = [fresh.draw(i) for i in order]
    assert [(fresh.sample_id(d["pos"]), [fresh.sample_id(n) for n in d["negs"]])
            for d in drawn] == ids


@pytest.mark.parametrize("kind", KINDS)
def test_triplet_items_match_jax(cohort, kind):
    """`ds[idx]` in one order on both sides: the port's anchor, positive
    and negative equal the JAX item's anchor, positive and the negative its
    `collate` takes; a cluster draw holds one negative a cell."""
    got_ds = _dataset(cohort, True, kind, 0, lookup=cohort["lookup"])
    want_ds = _dataset(cohort, False, kind, 0, lookup=cohort["lookup"])
    for idx in (0, 3, 5, 0, 7):
        got, want = got_ds[idx], want_ds[idx]
        assert set(got) == {"anchor", "pos", "neg"}
        for role, ref in (("anchor", want["anchor"]), ("pos", want["pos"]),
                          ("neg", _negative(want))):
            _same(got[role], ref, f"{kind} {idx} {role}")
        assert got["pos"]["sample_id"] != got["anchor"]["sample_id"]
    if kind.endswith("cluster"):
        assert len(got_ds.draw(0)["negs"]) == 3  # the 3 other cells


@pytest.mark.parametrize("std,noise_seed", [(0.5, 0), (0.25, 3)])
def test_meta_tau_noise_matches_jax(cohort, std, noise_seed):
    """The per-subject meta-tau noise, in one process (its seed is a
    salted string hash: ROADMAP.md section 3): the port's covars[5] equal
    the JAX dataset's, and differ from the noiseless label."""
    got = []
    for port in (True, False):
        d = pdata if port else jdata
        cov, quart, preds = _tables(cohort, port)
        ds = d.RegressionVolumeDataset(cohort["lookup"], cov, quart,
                                       meta_tau_table=preds, pad_dims=(S, S, S),
                                       meta_tau_noise_std=std, noise_seed=noise_seed)
        got.append([ds.meta_tau(i) for i in range(8)])
        if port:
            _same(ds[2]["anchor"]["covars"][5], np.float32(got[0][2]))
    assert got[0] == got[1]
    assert not np.allclose(got[0], [1.0 + i for i in range(8)])


def test_loader_reads_only_what_the_batch_uses(cohort, monkeypatch):
    """RnC (no triplets) reads the anchors' 3 files a sample and no
    partner; tCDS reads 3 subjects a sample, where the JAX cluster item
    reads 5 here (anchor, positive, a negative from each of 3 cells)."""
    reads = []
    real = pdatasets.VolumeDataset.load_volume_files

    def counting(self, paths):
        reads.extend(paths)
        return real(self, paths)

    monkeypatch.setattr(pdatasets.VolumeDataset, "load_volume_files", counting)
    preds = _tables(cohort, True)[2]
    for triplets, per_sample in ((False, 3), (True, 9)):
        reads.clear()
        ds = _dataset(cohort, True, "regression_cluster", 0, lookup=cohort["lookup"])
        batches = list(pdata.DataLoader(ds, 2, predictions=preds,
                                        with_triplets=triplets, num_workers=2))
        assert len(batches) == 4
        assert len(reads) == 8 * per_sample
        assert ("pos_mri" in batches[0]) == triplets


def test_resumed_pass_draws_the_uninterrupted_partners(cohort):
    """A loader told `set_epoch(3)` after one pass draws, in its next
    pass, the partners that a loader which made passes 0-2 draws in pass
    3 (the training loop's resume)."""
    preds = _tables(cohort, True)[2]

    def loader():
        ds = _dataset(cohort, True, "regression_cluster", 1)
        return pdata.DataLoader(ds, 2, predictions=preds, with_triplets=True,
                                shuffle=True, seed=4, num_workers=3)

    straight, resumed = loader(), loader()
    for _ in range(3):
        list(straight)
    next(iter(resumed))
    resumed.set_epoch(3)
    want, got = list(straight), list(resumed)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _same(g, w)


# ------------------------------------------------------------ other datasets
def _with_missing_abeta(c, tmp_path):
    rows = read_csv(c["cov"]).rows()
    rows[2]["Abeta_Covar"] = None
    path = str(tmp_path / "cov_missing.csv")
    write_rows(path, rows)
    return path


@pytest.mark.parametrize("name", ["combined", "combined_bare", "a4"])
def test_other_datasets_match_jax(cohort, tmp_path, name):
    """`CombinedVolumeDataset` with the cognition and abeta fallback tables
    (subject 2's abeta missing) and without them, and `A4VolumeDataset`."""
    cov_csv = _with_missing_abeta(cohort, tmp_path)
    ids = [pdata.extract_id(r["tau"]) for r in read_csv(cohort["lookup"]).rows()]
    cognition = {ids[1]: 27.0, ids[2]: 21.5}
    fallback = {ids[2]: 1.0, ids[3]: 0.0}
    items = []
    for port in (True, False):
        d, mod = (pdata, pcov) if port else (jdata, jcov)
        cov, preds = mod.CovariateTable(cov_csv), mod.PredictionTable(cohort["preds"])
        if name == "a4":
            ds = d.A4VolumeDataset(cohort["lookup"], cov, pad_dims=(S, S, S))
        elif name == "combined":
            ds = d.CombinedVolumeDataset(cohort["lookup"], cov, meta_tau_table=preds,
                                         cognition_table=cognition,
                                         abeta_fallback_table=fallback,
                                         pad_dims=(S, S, S))
        else:
            ds = d.CombinedVolumeDataset(cohort["lookup"], cov, pad_dims=(S, S, S))
        items.append([ds[i] for i in range(4)])
    _same(items[0], items[1])
    if name == "combined":
        assert items[0][2]["abeta"] == 1.0 and items[0][2]["covars"][0] == 1.0
        assert items[0][1]["covars"][4] == np.float32(27.0 / 30.0)


@pytest.mark.parametrize("skip,shuffle", [((), False), ((1,), False), ((0, 5), True)])
def test_custom_sampler_matches_jax(cohort, tmp_path, skip, shuffle):
    cov_csv = _with_missing_abeta(cohort, tmp_path)
    got = []
    for port in (True, False):
        d, mod = (pdata, pcov) if port else (jdata, jcov)
        ds = d.ContrastiveVolumeDataset(cohort["lookup"], mod.CovariateTable(cov_csv),
                                        mod.QuartileTable(cohort["quart"]),
                                        pad_dims=(S, S, S))
        sampler = d.CustomSampler(ds, skip_ids=[ds.sample_id(i) for i in skip],
                                  shuffle=shuffle, rnd_seed=3)
        got.append((list(sampler), len(sampler)))
    assert got[0] == got[1] and got[0][1] == 8 - len(skip)


def test_orchestration_matches_jax(cohort, tmp_path):
    """`load_split_datasets` (fold 2, the prediction JSON by path, both
    modes), `load_single_split_datasets` with its size check,
    `create_dataloader` with the sampler, and `check_for_longitudinal`."""
    rows = read_csv(cohort["lookup"]).rows()
    write_rows(str(tmp_path / "training_lookup_2.csv"), rows)
    write_rows(str(tmp_path / "test_lookup_2.csv"), rows[:3])
    for mode in ("cluster", "contrastive"):
        splits = [mod.load_split_datasets(str(tmp_path), 2, cohort["cov"],
                                          cohort["quart"], cohort["preds"],
                                          mode=mode, pad_dims=(S, S, S))
                  for mod in (porch, jorch)]
        for (p_ds, j_ds) in zip(*splits):
            assert len(p_ds) == len(j_ds)
            for idx in (0, 2):
                got, want = p_ds[idx], j_ds[idx]
                _same(got["anchor"], want["anchor"])
                _same(got["neg"], _negative(want))
    p_train, p_test = porch.load_single_split_datasets(
        cohort["lookup"], str(tmp_path / "test_lookup_2.csv"), cohort["cov"],
        expected_sizes=(8, 3), pad_dims=(S, S, S))
    j_train, _ = jorch.load_single_split_datasets(
        cohort["lookup"], cohort["lookup"], cohort["cov"], pad_dims=(S, S, S))
    assert (len(p_train), len(p_test)) == (8, 3)
    _same(p_train[4], j_train[4])
    with pytest.raises(AssertionError, match="1695"):
        porch.load_single_split_datasets(cohort["lookup"], cohort["lookup"],
                                         cohort["cov"], expected_sizes=(1695, 444))
    loaders = []
    for mod, d, tables in ((porch, pdata, pcov), (jorch, jdata, jcov)):
        ds = d.ClusterVolumeDataset(cohort["lookup"], tables.CovariateTable(cohort["cov"]),
                                    tables.QuartileTable(cohort["quart"]),
                                    pad_dims=(S, S, S))
        loaders.append(mod.create_dataloader(ds, 2, shuffle=True, contra=True,
                                             num_workers=1))
    assert list(loaders[0].sampler) == list(loaders[1].sampler)
    assert not loaders[0].shuffle
    _same(next(iter(loaders[0])), next(iter(loaders[1])))
    paths = [r["tau"] for r in rows] + [rows[0]["tau"].replace("2020-01-01", "2021-01-01")]
    assert porch.check_for_longitudinal(paths) == jorch.check_for_longitudinal(paths)
    assert porch.check_for_longitudinal(paths) == {"000-S-1000": 2}


# ------------------------------------------------------------ the loop
class InOrder:
    """The JAX loop's loader for the parity: the JAX dataset indexed in the
    port loader's order on one thread, each pass read whole when it starts
    (as the port draws it), collated by JAX with the triplets."""

    def __init__(self, ds, preds, like):
        self.ds, self.preds, self.like, self.epoch = ds, preds, like, 0

    def __iter__(self):
        batches, valid = self.like._batches(self.epoch)
        self.epoch += 1
        samples = [[self.ds[i] for i in b] for b in batches]
        for items, n in zip(samples, valid):
            batch = jdata.collate(items, self.preds, with_triplets=True)
            batch["valid"] = np.arange(len(items)) < n
            yield batch


def _config(mod, epochs):
    return mod.ExperimentConfig(
        model=mod.ModelConfig(**MODEL),
        loss=mod.LossConfig(rnc=False, reg_weight=0.1, cds_weights=(0.0, 1.0, 4.0)),
        train=mod.TrainConfig(epochs=epochs, val_iter=1, checkpoint_iter=1, lr=LR),
        data=mod.DataConfig(volume_shape=(S, S, S)))


def _no_charts(mp):
    noop = lambda *a, **k: None  # noqa: E731
    for mod, rec in ((jloop, JRecorder), (ploop, PRecorder)):
        mp.setattr(mod, "loss_graph", noop)
        mp.setattr(rec, "plot", noop)


@pytest.fixture(scope="module")
def loop_runs(cohort):
    """Two epochs of each loop from the flax init: 4 subjects in 2 shuffled
    triplet batches an epoch, validation on 4 every epoch."""
    example = (np.zeros((2, 1, S, S, S), np.float32), np.zeros((2, 6), np.float32),
               np.zeros((2, R), np.float32), np.zeros((2, R), np.float32),
               np.zeros((2, S, S, S), np.int32))
    flax_model = FlaxContra(jconfig.ModelConfig(**MODEL))
    init = fast(jax.jit(lambda key, *a: flax_model.init(key, *a, train=True)))
    variables = jax.device_get(init(jax.random.PRNGKey(0), *example))

    def loaders(port):
        d = pdata if port else jdata
        cov, quart, preds = _tables(cohort, port)
        train = d.PredictedMetaTauDataset(cohort["train"], cov, quart,
                                          meta_tau_table=preds, pad_dims=(S, S, S))
        val = d.PredictedMetaTauDataset(cohort["test"], cov, quart,
                                        meta_tau_table=preds, pad_dims=(S, S, S))
        like = pdata.DataLoader(train, 2, predictions=preds, with_triplets=True,
                                shuffle=True, num_workers=4)
        val_loader = d.DataLoader(val, 2, predictions=preds, num_workers=2)
        return (like if port else InOrder(train, preds, like)), val_loader

    losses = []
    base = fast(j_make_train_step(flax_model, _config(jconfig, 2).loss, donate=True))

    def step(state, batch, roi_w, rng, *rest):
        state, aux = base(state, batch, roi_w, rng, *rest)
        losses.append(float(aux["loss"]))
        return state, aux

    def create_state(model, tx, rng, example, kwargs=None, variables=None):
        return j_create_state(model, tx, rng, example, kwargs, variables=VARS[0])

    VARS = [variables]
    out = {"jax": os.path.join(cohort["out"], "jax"),
           "port": os.path.join(cohort["out"], "port")}
    with pytest.MonkeyPatch.context() as mp:
        _no_charts(mp)
        mp.setattr(jloop, "create_train_state", create_state)
        train_loader, val_loader = loaders(False)
        jloop.train(flax_model, _config(jconfig, 2), train_loader,
                    val_loader=val_loader, save_path=out["jax"], train_step=step,
                    eval_step=fast(j_make_eval_step(flax_model, R)))
        model = ContraAttnUNet(_config(pconfig, 2).model, device="cpu")
        model.load_state_dict(from_flax(variables["params"], model))
        train_loader, val_loader = loaders(True)
        ploop.train(model, _config(pconfig, 2), train_loader, val_loader=val_loader,
                    save_path=out["port"], device="cpu")
    out.update(jax_losses=losses, run=dict(ploop.LAST_RUN))
    return out


def _rel_close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    assert (np.isnan(got) == np.isnan(want)).all(), (what, got, want)
    ok = ~np.isnan(want)
    err = np.abs(got[ok] - want[ok])
    assert (err <= tol * np.maximum(np.abs(want[ok]), 1e-6)).all(), (
        what, float((err / np.maximum(np.abs(want[ok]), 1e-6)).max()))


def test_tcds_step_losses_match_jax(loop_runs):
    got = [v for e in loop_runs["run"]["epochs"] for v in e["losses"]]
    assert len(got) == len(loop_runs["jax_losses"]) == 4
    _rel_close(got, loop_runs["jax_losses"], STEP_TOL, "step losses")
    assert len({round(v, 6) for v in got}) == 4


@pytest.mark.parametrize("sub", ["", "pos_metrics", "neg_metrics"])
def test_tcds_validation_csvs_match_jax(loop_runs, sub):
    want_dir = os.path.join(loop_runs["jax"], sub, "validation_metric_results")
    got_dir = os.path.join(loop_runs["port"], sub, "validation_metric_results")
    names = sorted(os.listdir(want_dir))
    assert names == sorted(os.listdir(got_dir)) and len(names) == 8
    for name in names:
        want, got = (read_csv(os.path.join(d, name)) for d in (want_dir, got_dir))
        assert got.columns == want.columns == ["epoch_0", "epoch_1"], name
        for col in want.columns:
            if "corr" in name:
                np.testing.assert_allclose(got[col], want[col], rtol=0,
                                           atol=CORR_ATOL, err_msg=name)
            else:
                _rel_close(got[col], want[col], CSV_TOL, f"{sub}/{name} {col}")


def test_tcds_epoch_losses_match_jax(loop_runs):
    from coma_unet_tpu_torch.train.checkpoint import load_checkpoint

    for epoch, record in enumerate(loop_runs["run"]["epochs"]):
        payload = load_checkpoint(os.path.join(loop_runs["port"], "checkpoints",
                                               f"checkpoint_epoch_{epoch}"))
        assert record["loss"] == payload["loss"] and payload["step"] == 2 * (epoch + 1)
        want = sum(loop_runs["jax_losses"][2 * epoch:2 * epoch + 2]) / 4
        _rel_close(payload["loss"], want, STEP_TOL, f"epoch {epoch}")


@pytest.mark.parametrize("how", ["tcds", "combined"])
def test_cli_trains_from_the_config(cohort, tmp_path, how):
    """`train --config` on the CPU, with `"loss": {"rnc": false}` (tCDS: a
    non-zero triplet term and the pos/neg recorders' CSVs), or with
    `--combined` and its cognition and abeta fallback JSONs (RnC: the
    combined dataset is flat, as the JAX package's)."""
    import json

    rows = read_csv(cohort["lookup"]).rows()
    splits = tmp_path / "splits"
    splits.mkdir()
    write_rows(str(splits / "training_lookup_4.csv"), rows[:4])
    write_rows(str(splits / "test_lookup_4.csv"), rows[4:6])
    ids = [pdata.extract_id(r["tau"]) for r in rows]
    (tmp_path / "cog.json").write_text(json.dumps({ids[0]: 24.0}))
    (tmp_path / "abeta.json").write_text(json.dumps({ids[1]: 1.0}))
    cfg = {"model": {k: list(v) if isinstance(v, tuple) else v
                     for k, v in MODEL.items()},
           "loss": {"rnc": how != "tcds", "cds_weights": [0.0, 1.0, 4.0]},
           "train": {"epochs": 1, "batch_size": 2, "val_iter": 1},
           "data": {"volume_shape": [S, S, S]},
           "save_path": str(tmp_path / "results")}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    extra = ([] if how == "tcds" else
             ["--combined", "--cognition_json", str(tmp_path / "cog.json"),
              "--abeta_fallback_json", str(tmp_path / "abeta.json")])
    assert cli_main(["train", "--config", str(tmp_path / "config.json"),
                     "--device", "cpu", "--covariate_csv", cohort["cov"],
                     "--quartile_csv", cohort["quart"], "--predictions_json",
                     cohort["preds"], "--splits_dir", str(splits)] + extra) == 0
    losses = ploop.LAST_RUN["epochs"][0]["losses"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    (run_dir,) = os.listdir(cfg["save_path"])
    for sub in ("pos_metrics", "neg_metrics"):
        assert os.path.isfile(os.path.join(cfg["save_path"], run_dir, sub,
                                           "validation_metric_results", "mape.csv"))


def test_combined_flag_selects_the_combined_dataset(cohort, tmp_path):
    """`--combined` builds `CombinedVolumeDataset`s from the JSON tables,
    triplet-free, and refuses the tCDS loss, which needs triplets (the JAX
    step fails on its missing partners); otherwise
    `PredictedMetaTauDataset`s, the training loader taking triplets where
    the config's loss is tCDS."""
    import json

    import dataclasses

    from coma_unet_tpu_torch.cli.main import (
        _build_loaders,
        _experiment_config,
        build_parser,
    )

    rows = read_csv(cohort["lookup"]).rows()
    write_rows(str(tmp_path / "training_lookup_4.csv"), rows[:4])
    write_rows(str(tmp_path / "test_lookup_4.csv"), rows[4:])
    (tmp_path / "cog.json").write_text(json.dumps({"x": 20.0}))
    base = ["train", "--splits_dir", str(tmp_path), "--covariate_csv", cohort["cov"],
            "--quartile_csv", cohort["quart"]]
    for extra, rnc, cls, triplets in (
            (["--combined", "--cognition_json", str(tmp_path / "cog.json")], True,
             pdata.CombinedVolumeDataset, False),
            ([], True, pdata.PredictedMetaTauDataset, False),
            ([], False, pdata.PredictedMetaTauDataset, True)):
        args = build_parser().parse_args(base + extra)
        cfg = dataclasses.replace(_experiment_config(args).normalized(),
                                  loss=pconfig.LossConfig(rnc=rnc))
        train_loader, test_loader = _build_loaders(args, cfg)
        assert type(train_loader.dataset) is cls and type(test_loader.dataset) is cls
        assert train_loader.with_triplets is triplets and not test_loader.with_triplets
        if cls is pdata.CombinedVolumeDataset:
            assert train_loader.dataset.cognition_table == {"x": 20.0}
            assert train_loader.dataset.abeta_fallback_table == {}
            with pytest.raises(ValueError, match="no triplets"):
                _build_loaders(args, dataclasses.replace(
                    cfg, loss=pconfig.LossConfig(rnc=False)))
