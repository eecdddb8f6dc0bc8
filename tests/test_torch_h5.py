"""The port's HDF5 layer (``tdgl_tpu_torch.utils.h5lite``) against h5py.

Files written by h5lite must open in h5py with the same names, dtypes,
shapes, values and attributes, for every type the output schema uses;
h5lite must read back what it wrote, handle ``r+`` appends and the
replacement of a group at every flush, and refuse files in HDF5's
default format with a clear ``OSError``. h5py is only the oracle here:
the port never imports it.
"""

import os
import shutil

import h5py
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tdgl_tpu_torch.utils import h5lite

CASES = {
    "float32_2d": np.arange(6, dtype=np.float32).reshape(2, 3) / 7,
    "float64_1d": np.linspace(-1.0, 1.0, 9),
    "int8": np.arange(-4, 4, dtype=np.int8),
    "int32": np.arange(10, dtype=np.int32) * -3,
    "int64_2d": np.arange(12, dtype=np.int64).reshape(3, 4) - 2**40,
    "uint8": np.arange(5, dtype=np.uint8),
    "complex64": (np.arange(4) - 1j * np.arange(4)).astype(np.complex64),
    "complex128_2d": np.array([[1 + 2j, 3 - 4j], [0.5j, -1.0]]),
    "bool": np.array([True, False, True, True]),
    "zero_size_2d": np.zeros((0, 3)),
    "zero_size_int": np.zeros(0, dtype=np.int64),
    "scalar_float64": np.float64(3.25),
    "scalar_float32": np.float32(-0.5),
    "scalar_int32": np.int32(7),
    "scalar_complex": np.complex128(1 - 1j),
    "scalar_bool": np.bool_(True),
    "void": np.void(b"\x00\x01pickled-bytes\xff"),
}

ATTRS = {
    "py_str": "a string",
    "py_empty_str": "",
    "py_utf8_str": "ünïcøde",
    "py_bool": True,
    "py_int": 3,
    "py_float": 2.5,
    "py_complex": 1 + 2j,
    "py_float_tuple": (1.0, 2.0),
    "py_int_tuple": (1, 2, 3),
    "py_array": np.arange(3.0),
    "py_np_bool": np.bool_(False),
    "py_np_int8": np.int8(-2),
}


def _same(got, want):
    if isinstance(want, np.void):
        return got.tobytes() == want.tobytes()
    if isinstance(want, str):
        return isinstance(got, str) and got == want
    got, want = np.asarray(got), np.asarray(want)
    return (got.dtype == want.dtype and got.shape == want.shape
            and np.array_equal(got, want))


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("h5lite") / "types.h5")
    with h5lite.File(path, "x") as f:
        for name, value in CASES.items():
            f[name] = value
            f.attrs[name] = value
        f.attrs.update(ATTRS)
    return path


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("reader", ["h5py", "h5lite"])
def test_dataset_and_attribute_types(written, reader, name):
    want = CASES[name]
    opener = h5py.File if reader == "h5py" else h5lite.File
    with opener(written, "r") as f:
        ds = f[name]
        assert ds.shape == np.shape(want)
        assert ds.dtype == np.asarray(want).dtype
        assert _same(ds[()], want)
        assert _same(np.asarray(ds), np.asarray(want))
        assert _same(f.attrs[name], want)


@pytest.mark.parametrize("reader", ["h5py", "h5lite"])
def test_python_attribute_values(written, reader):
    opener = h5py.File if reader == "h5py" else h5lite.File
    with opener(written, "r") as f:
        for name, want in ATTRS.items():
            got = f.attrs[name]
            if isinstance(want, str):
                assert type(got) is str and got == want, name
            else:
                # h5py's conversions: bool -> np.bool_, int -> int64,
                # float -> float64, tuple -> array.
                assert np.array_equal(got, want), name
                assert np.asarray(got).dtype == np.asarray(want).dtype, name
    with h5py.File(written, "r") as ref, h5lite.File(written, "r") as f:
        assert sorted(f.attrs.keys()) == sorted(ref.attrs.keys())
        for name in ref.attrs:
            assert type(f.attrs[name]) is type(ref.attrs[name]), name


@pytest.mark.parametrize("reader", ["h5py", "h5lite"])
def test_groups_paths_and_creation_order(tmp_path, reader):
    path = str(tmp_path / "groups.h5")
    order = ["3", "1", "10", "2", "0"]
    with h5lite.File(path, "w") as f:
        data = f.create_group("data", track_order=True)
        for n in order:
            g = data.create_group(n)
            g.attrs["step"] = int(n)
            g["running_state/dt"] = np.full(2, float(n))
        plain = f.create_group("terminals")
        for n in ("source", "drain", "b"):
            plain.create_group(n).attrs["name"] = n
        f.create_group("a/b/c").attrs["deep"] = "yes"
        f["a/b/d"] = np.ones(2)
        assert f.require_group("a/b") is not None
        with pytest.raises(ValueError):
            f.create_group("a/b")
    opener = h5py.File if reader == "h5py" else h5lite.File
    with opener(path, "r") as f:
        assert list(f["data"]) == order
        assert [int(g.attrs["step"]) for g in f["data"].values()] == \
            [int(n) for n in order]
        assert list(f["terminals"]) == ["b", "drain", "source"]
        assert sorted(f) == ["a", "data", "terminals"]
        assert list(f["a/b"]) == ["c", "d"]
        assert f["a/b/c"].attrs["deep"] == "yes"
        assert "a/b/d" in f and "a/x" not in f and "a/b/x" not in f
        assert np.array_equal(f["data/10/running_state/dt"][()], [10.0, 10.0])


def test_r_plus_append_and_group_replacement(tmp_path):
    path = str(tmp_path / "runner.h5")
    sizes = []
    with h5lite.File(path, "x") as f:
        data = f.create_group("data", track_order=True)
        for k in range(6):
            data.create_group(str(k))["psi"] = np.full(100, k, np.complex64)
            if "checkpoint" in f:
                del f["checkpoint"]
            ck = f.create_group("checkpoint")
            ck["psi_r"] = np.full((64, 64), k, np.float32)
            ck.attrs.update(backend="grid", step=k, done=False)
            f.flush()
            sizes.append(os.path.getsize(path))
            # The flushed file is complete while the writer keeps it open.
            with h5py.File(path, "r") as ref:
                assert ref["checkpoint/psi_r"][0, 0] == k
                assert ref["checkpoint"].attrs["step"] == k
                assert list(ref["data"]) == [str(i) for i in range(k + 1)]
    # A replaced group reuses the space freed one flush earlier.
    assert sizes[-1] == sizes[2], sizes
    with h5lite.File(path, "r+") as f:
        sol = f.require_group("solution")
        sol.attrs["total_seconds"] = 1.5
        sol.create_group("device")["points"] = np.eye(2)
        del f["checkpoint"]
        f.create_group("checkpoint")["psi_r"] = np.zeros(3, np.float32)
    for opener in (h5py.File, h5lite.File):
        with opener(path, "r") as f:
            assert sorted(f) == ["checkpoint", "data", "solution"]
            assert f["solution"].attrs["total_seconds"] == 1.5
            assert np.array_equal(f["solution/device/points"][()], np.eye(2))
            assert f["checkpoint/psi_r"].shape == (3,)
            assert np.array_equal(f["data/5/psi"][()],
                                  np.full(100, 5, np.complex64))


def test_unflushed_changes_leave_the_last_flush_readable(tmp_path):
    path = str(tmp_path / "flush.h5")
    copy = str(tmp_path / "copy.h5")
    f = h5lite.File(path, "x")
    f["kept"] = np.arange(4)
    f.flush()
    del f["kept"]
    f["later"] = np.arange(1000.0)
    f.create_group("g").attrs["x"] = "y"
    shutil.copy(path, copy)  # as if the writer died here
    f.close()
    with h5py.File(copy, "r") as ref:
        assert list(ref) == ["kept"]
        assert np.array_equal(ref["kept"][()], np.arange(4))
    with h5py.File(path, "r") as ref:
        assert sorted(ref) == ["g", "later"]


@pytest.mark.parametrize("value", [None, {"source": 1.0}, object(), len,
                                   np.array(["a", "b"])])
def test_unstorable_attributes_raise_type_error(tmp_path, value):
    # Solution.to_hdf5 pickles what cannot be an attribute, as with h5py.
    with h5lite.File(str(tmp_path / "bad.h5"), "w") as f:
        with pytest.raises(TypeError):
            f.attrs["x"] = value
    with h5py.File(str(tmp_path / "ref.h5"), "w") as f:
        with pytest.raises(TypeError):
            f.attrs["x"] = value


@pytest.mark.parametrize("kind", ["default_format", "chunked", "not_hdf5"])
def test_reader_rejects_other_formats(tmp_path, kind):
    path = str(tmp_path / f"{kind}.h5")
    if kind == "not_hdf5":
        with open(path, "wb") as fh:
            fh.write(b"not an hdf5 file at all" * 4)
    else:
        libver = "latest" if kind == "chunked" else None
        with h5py.File(path, "w", libver=libver) as f:
            if kind == "chunked":
                f.create_dataset("x", data=np.ones(100), chunks=(10,),
                                 compression="gzip")
            else:
                f["x"] = np.ones(3)
    expected = {"default_format": "superblock version 0",
                "chunked": "h5lite does not read",
                "not_hdf5": "not an HDF5 file"}[kind]
    with pytest.raises(OSError, match=expected):
        with h5lite.File(path, "r") as f:
            np.asarray(f["x"])


def test_lookup3_is_hdf5s_checksum(tmp_path):
    path = str(tmp_path / "sb.h5")
    with h5py.File(path, "w", libver="latest"):
        pass
    with open(path, "rb") as fh:
        superblock = fh.read(48)
    assert h5lite.lookup3(superblock[:44]) == int.from_bytes(
        superblock[44:48], "little")
    assert h5lite.lookup3(b"") == 0xDEADBEEF


_DTYPES = st.sampled_from(["f4", "f8", "i1", "i4", "i8", "u2", "c8", "c16",
                           "?"])


@settings(max_examples=20, deadline=None)
@given(dtype=_DTYPES,
       shape=st.lists(st.integers(0, 4), min_size=0, max_size=3),
       seed=st.integers(0, 2**31 - 1))
def test_random_arrays_round_trip(tmp_path_factory, dtype, shape, seed):
    rng = np.random.default_rng(seed)
    raw = rng.normal(size=tuple(shape)) * 100
    if dtype.startswith("c"):
        raw = raw + 1j * rng.normal(size=tuple(shape))
    value = np.asarray(raw > 0 if dtype == "?" else raw).astype(dtype)
    path = str(tmp_path_factory.mktemp("hyp") / "x.h5")
    with h5lite.File(path, "w") as f:
        f.create_group("g")["x"] = value
        f["g"].attrs["x"] = value
    for opener in (h5py.File, h5lite.File):
        with opener(path, "r") as f:
            assert _same(f["g/x"][()], value)
            assert _same(f["g"].attrs["x"], value)
