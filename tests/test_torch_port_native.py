"""The port's native NIfTI reader (`coma_unet_tpu_torch/runtime/`) against
its plain version, the port's numpy reader (`load_nifti_vol` then
`center_pad_crop`), and the JAX package's readers, on the CPU.

Intensities within rtol 1e-6 (both sides decode and scale in float32, so
they agree bit for bit here), ROI labels exactly; `.nii` and `.nii.gz`,
either byte order, every datatype the numpy reader takes, resampling from
1, 1.5 and 2 mm and odd sizes whose resampled size is a half, rounded to
even as numpy rounds. A batch load equals single loads; a file it cannot
read raises IOError; a build that fails raises RuntimeError, also through a
dataset, with no fallback; the build needs no zlib header.
"""

import struct
import threading

import numpy as np
import pytest

pytest.importorskip("jax")

from coma_unet_tpu.io.volume import load_nifti_vol as j_load  # noqa: E402
from coma_unet_tpu.ops.preprocess import center_pad_crop as j_pad  # noqa: E402
from coma_unet_tpu.runtime import native as jnative  # noqa: E402

from coma_unet_tpu_torch.data import VolumeDataset  # noqa: E402
from coma_unet_tpu_torch.data.synthetic import make_synthetic_cohort  # noqa: E402
from coma_unet_tpu_torch.io.nifti import write_nifti  # noqa: E402
from coma_unet_tpu_torch.io.volume import load_nifti_vol  # noqa: E402
from coma_unet_tpu_torch.ops.preprocess import center_pad_crop  # noqa: E402
from coma_unet_tpu_torch.runtime import native  # noqa: E402

# (shape (x, y, z), spacing, dtype, gz): a label volume, intensities of each
# type, resampling down and up, sizes whose resampled size is n.5
CASES = {
    "labels_int16_gz": ((16, 16, 16), (2.0, 2.0, 2.0), np.int16, True),
    "float32_1mm": ((20, 18, 16), (1.0, 1.0, 1.0), np.float32, False),
    "float64_aniso_gz": ((20, 18, 16), (1.0, 1.5, 2.0), np.float64, True),
    "uint8_up": ((11, 12, 9), (1.3, 2.7, 0.9), np.uint8, False),
    "odd_half_sizes": ((13, 15, 17), (1.0, 1.0, 1.0), np.float32, True),
    "int32": ((10, 9, 8), (2.0, 2.0, 2.0), np.int32, False),
    "uint16": ((10, 9, 8), (1.5, 1.5, 1.5), np.uint16, True),
    "int8": ((10, 9, 8), (2.0, 2.0, 2.0), np.int8, False),
    "uint32": ((10, 9, 8), (2.0, 2.0, 2.0), np.uint32, False),
    "int64": ((10, 9, 8), (2.0, 2.0, 2.0), np.int64, True),
    "uint64": ((10, 9, 8), (2.0, 2.0, 2.0), np.uint64, False),
}
TARGETS = [(16, 16, 16), (9, 20, 11)]


def _volume(rng, shape, dtype):
    if np.dtype(dtype).kind == "f":
        a = rng.uniform(-50, 500, size=shape).astype(dtype)
        a.flat[::97] = np.nan
        return a
    info = np.iinfo(dtype)
    hi = min(int(info.max), 2000)
    return rng.integers(max(int(info.min), -hi), hi, size=shape).astype(dtype)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(0)
    out = {}
    for name, (shape, spacing, dtype, gz) in CASES.items():
        path = str(root / (name + (".nii.gz" if gz else ".nii")))
        if name.startswith("labels"):
            labels = np.array([0, 2, 4, 17, 1035, 2035], np.int16)
            write_nifti(path, labels[rng.integers(0, 6, size=shape)], spacing=spacing)
        else:
            write_nifti(path, _volume(rng, shape, dtype), spacing=spacing)
        out[name] = path
    return out


def _plain(path, target, resize=True):
    return center_pad_crop(load_nifti_vol(path, resize=resize), target)


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("resize", [True, False])
@pytest.mark.parametrize("name", sorted(CASES))
def test_native_matches_the_numpy_readers(files, name, resize, target):
    got = native.load_volume_native(files[name], target, resize=resize)
    want = _plain(files[name], target, resize)
    assert got.shape == want.shape == (1,) + target and got.dtype == np.float32
    if name.startswith("labels"):
        np.testing.assert_array_equal(got, want)
        assert set(np.unique(got)) <= {0, 2, 4, 17, 1035, 2035}
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got, j_pad(j_load(files[name], resize=resize), target),
                               rtol=1e-6, atol=0)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("name", ["labels_int16_gz", "float32_1mm", "uint8_up"])
def test_native_matches_the_jax_native_reader(files, name):
    """Where no resampled size is a half, the JAX package's own C++ reader
    agrees (at a half it rounds up where numpy rounds to even: ROADMAP.md
    section 3)."""
    if not jnative.native_available():
        pytest.skip("the JAX package's native reader does not build here")
    for target in TARGETS:
        np.testing.assert_allclose(native.load_volume_native(files[name], target),
                                   jnative.load_volume_native(files[name], target),
                                   rtol=1e-6, atol=0)


def _big_endian(path, data_xyz, spacing):
    """A big-endian single-file NIfTI-1 of int16 data, written field by
    field."""
    hdr = bytearray(348)
    struct.pack_into(">i", hdr, 0, 348)
    struct.pack_into(">8h", hdr, 40, 3, *data_xyz.shape, 1, 1, 1, 1)
    struct.pack_into(">hh", hdr, 70, 4, 16)
    struct.pack_into(">8f", hdr, 76, 1.0, *spacing, 1.0, 1.0, 1.0, 1.0)
    struct.pack_into(">fff", hdr, 108, 352.0, 2.0, -3.0)
    hdr[344:348] = b"n+1\0"
    with open(path, "wb") as f:
        f.write(bytes(hdr) + b"\0" * 4)
        f.write(np.asarray(data_xyz, ">i2").tobytes(order="F"))


def test_native_reads_big_endian_and_scales(tmp_path):
    a = np.random.default_rng(1).integers(-300, 300, size=(13, 10, 9)).astype(np.int16)
    path = str(tmp_path / "big.nii")
    _big_endian(path, a, (1.0, 2.0, 1.5))
    want = _plain(path, (12, 12, 12))
    got = native.load_volume_native(path, (12, 12, 12))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    raw = native.load_volume_native(path, (13, 10, 9)[::-1], resize=False)[0]
    np.testing.assert_array_equal(raw, np.transpose(a, (2, 1, 0)) * 2.0 - 3.0)


def test_batch_load_equals_single_loads(files):
    paths = [files[n] for n in sorted(CASES)]
    for threads in (0, 1, 3):
        batch = native.load_batch_native(paths, (16, 16, 16), num_threads=threads)
        assert batch.shape == (len(paths), 16, 16, 16)
        for i, p in enumerate(paths):
            np.testing.assert_array_equal(batch[i],
                                          native.load_volume_native(p, (16, 16, 16))[0])
    assert native.load_batch_native([], (4, 4, 4)).shape == (0, 4, 4, 4)


def test_unreadable_files_raise_ioerror(files, tmp_path):
    junk = tmp_path / "junk.nii"
    junk.write_bytes(b"not a nifti file" * 40)
    with pytest.raises(IOError, match="missing.nii"):
        native.load_volume_native(str(tmp_path / "missing.nii"), (8, 8, 8))
    with pytest.raises(IOError, match=r"1 of 2 files: \['.*junk.nii'\]"):
        native.load_batch_native([files["int8"], str(junk)], (8, 8, 8))
    with pytest.raises(ValueError, match="3 positive"):
        native.load_volume_native(files["int8"], (8, 8))


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """An empty build directory and no library loaded yet."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    return tmp_path


def test_a_failed_build_raises_and_never_falls_back(fresh_build, monkeypatch, files):
    cohort = make_synthetic_cohort(str(fresh_build / "cohort"), n_subjects=2)
    monkeypatch.setattr(native, "CXX", "false")
    with pytest.raises(RuntimeError, match="building the native NIfTI reader failed"):
        native.load_volume_native(files["int8"], (8, 8, 8))
    with pytest.raises(RuntimeError, match="native NIfTI reader"):
        VolumeDataset(cohort["lookup"], pad_dims=(16, 16, 16))[0]
    monkeypatch.setattr(native, "CXX", "no-such-compiler-on-path")
    with pytest.raises(RuntimeError, match="not found"):
        native.build()
    assert not list((fresh_build / "build").glob("*.so"))


def test_the_build_needs_no_zlib_header(fresh_build, monkeypatch, files):
    """Built against an include directory whose zlib.h is an #error, the
    reader still builds, into the build directory under a hash of its
    source and command, and reads gzip files; a second build reuses it."""
    shadow = fresh_build / "include"
    shadow.mkdir()
    (shadow / "zlib.h").write_text('#error "zlib.h is not needed"\n')
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-I", str(shadow)))
    lib = native.build()
    assert lib.parent == fresh_build / "build" and lib.name.startswith("libcoma_nifti_")
    got = native.load_volume_native(files["labels_int16_gz"], (16, 16, 16))
    np.testing.assert_array_equal(got, _plain(files["labels_int16_gz"], (16, 16, 16)))

    def no_compiler(*a, **k):
        raise AssertionError("rebuilt a library that exists")

    monkeypatch.setattr(native.subprocess, "run", no_compiler)
    assert native.build() == lib
    assert not list(lib.parent.glob("*.tmp"))


def test_threads_that_load_at_once_share_one_build(fresh_build, files):
    """Eight threads reach an empty build directory at once: one library
    is built and loaded, and every thread reads the same volume."""
    results, errors = [None] * 8, []

    def work(i):
        try:
            results[i] = native.load_volume_native(files["float32_1mm"], (12, 12, 12))
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(list((fresh_build / "build").glob("*.so"))) == 1
    for r in results[1:]:
        np.testing.assert_array_equal(r, results[0])
