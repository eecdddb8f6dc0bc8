"""The port's HDF5 layer (``tdgl_tpu_torch.utils.h5lite``) against h5py.

Files written by h5lite must open in h5py with the same names, dtypes,
shapes, values and attributes, for every type the output schema uses;
h5lite must read back what it wrote and handle ``r+`` appends and the
replacement of a group at every flush. Files that h5py writes in HDF5's
default format (as ``tdgl_tpu`` writes its output) must read in h5lite
equal to h5py: every type, 0-d and n-d, as datasets and attributes, empty
arrays, variable-length strings of 0, 1 and 10,000 bytes, symbol-table
groups whose B-tree has two levels (300 links), a creation-ordered group
with dense link storage (300 links), an object header with continuation
blocks, a compact dataset, a file still open in its writer after a flush,
and random small trees; such a file opened ``"r+"``, and chunked or
compressed datasets, raise ``OSError``. h5py is only the oracle here: the
port never imports it.
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
    # h5lite reads HDF5's default format but appends only to its own files:
    # a default-format file opened "r+" raises.
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
    mode = "r+" if kind == "default_format" else "r"
    with pytest.raises(OSError, match=expected):
        with h5lite.File(path, mode) as f:
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


# -- HDF5's default format, as h5py writes it ------------------------------------
def _assert_same_tree(path):
    """Every group, dataset and attribute of ``path`` reads in h5lite as in
    h5py: names (in h5py's order), dtypes, shapes and values."""
    with h5py.File(path, "r") as ref, h5lite.File(path, "r") as f:
        def compare(r, g):
            assert sorted(g.attrs) == sorted(r.attrs), r.name
            for key in r.attrs:
                want = r.attrs[key]
                assert type(g.attrs[key]) is type(want), (r.name, key)
                assert _same(g.attrs[key], want), (r.name, key)
            if isinstance(r, h5py.Dataset):
                want = r[()]
                if r.dtype.kind == "O":  # h5py reads vlen strings as bytes
                    want = np.array([v.decode() for v in np.ravel(want)],
                                    dtype=h5lite.VLEN_STR).reshape(r.shape)
                    assert np.array_equal(g[()], want), r.name
                else:
                    assert g.shape == r.shape and g.dtype == r.dtype, r.name
                    assert _same(g[()], want), r.name
                return
            assert list(g) == list(r), r.name
            for key in r:
                compare(r[key], g[key])

        compare(ref, f)


@pytest.fixture(scope="module")
def default_format(tmp_path_factory):
    """A file in h5py's default format (superblock 0, version-1 headers)."""
    path = str(tmp_path_factory.mktemp("h5py") / "default.h5")
    with h5py.File(path, "w") as f:
        for name, value in CASES.items():
            f[name] = value
            f.attrs[name] = value
        f.attrs.update(ATTRS)
        strings = f.create_group("strings")
        for n in (0, 1, 10_000):
            strings.attrs[f"s{n}"] = "\u00e9" * (n // 2) + "x" * (n % 2)
        strings["vlen"] = np.array(["", "a", "y" * 10_000],
                                   dtype=h5py.string_dtype())
        plain = f.create_group("plain")
        for k in range(300):
            plain.create_group(str(k)).attrs["k"] = k
        ordered = f.create_group("ordered", track_order=True)
        for k in range(300):
            ordered.create_group(str(299 - k))["x"] = np.full(2, k)
        # Attributes added one at a time overflow the header into
        # continuation blocks.
        many = f.create_group("many_attrs")
        for k in range(40):
            many.attrs[f"a{k}"] = np.arange(k, dtype=np.float32)
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        space = h5py.h5s.create_simple((5,))
        ds = h5py.h5d.create(f.id, b"compact", h5py.h5t.NATIVE_DOUBLE, space,
                             dcpl=dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.arange(5.0))
    with open(path, "rb") as fh:
        assert fh.read(9)[8] == 0  # superblock version 0
    return path


@pytest.mark.parametrize("name", sorted(CASES))
def test_default_format_types(default_format, name):
    want = CASES[name]
    with h5lite.File(default_format, "r") as f:
        assert f[name].shape == np.shape(want)
        assert f[name].dtype == np.asarray(want).dtype
        assert _same(f[name][()], want)
        assert _same(f.attrs[name], want)


def test_default_format_tree(default_format):
    _assert_same_tree(default_format)
    with h5lite.File(default_format, "r") as f:
        assert f["strings"].attrs["s10000"] == "\u00e9" * 5000
        assert f["strings"].attrs["s0"] == ""
        assert f["strings/vlen"][()][2] == "y" * 10_000
        assert list(f["ordered"]) == [str(299 - k) for k in range(300)]
        assert np.array_equal(f["ordered/0/x"][()], [299, 299])
        assert sorted(f["plain"], key=int) == [str(k) for k in range(300)]
        assert f["plain/271"].attrs["k"] == 271
        assert len(f["many_attrs"].attrs) == 40
        assert np.array_equal(f["compact"][()], np.arange(5.0))


def test_default_format_while_writer_holds_it(tmp_path):
    """A file that h5py flushed and still holds open (as after a SIGKILL
    between flushes) reads as h5py reads it."""
    path = str(tmp_path / "open.h5")
    copy = str(tmp_path / "copy.h5")
    f = h5py.File(path, "w")
    data = f.create_group("data", track_order=True)
    for k in range(12):
        data.create_group(str(k))["psi"] = np.full(50, k, np.complex64)
    ck = f.create_group("checkpoint")
    ck["psi_r"] = np.arange(8.0)
    ck.attrs.update(backend="grid", step=7, time=0.5, done=False)
    f.flush()
    shutil.copy(path, copy)  # as if the writer died here
    with h5lite.File(path, "r") as live:  # h5lite takes no lock
        assert live["checkpoint"].attrs["step"] == 7
        assert list(live["data"]) == [str(k) for k in range(12)]
    f.close()
    _assert_same_tree(copy)


@pytest.mark.parametrize("kind", ["chunked", "gzip", "r_plus",
                                  "committed_type", "dense_attrs"])
def test_default_format_unsupported_raises(tmp_path, kind):
    path = str(tmp_path / f"{kind}.h5")
    with h5py.File(path, "w") as f:
        if kind == "chunked":
            f.create_dataset("x", data=np.ones(100), chunks=(10,))
        elif kind == "gzip":
            f.create_dataset("x", data=np.ones(100), compression="gzip")
        elif kind == "committed_type":
            f["t"] = np.dtype("f8")
            f.create_dataset("x", (3,), dtype=f["t"])
        elif kind == "dense_attrs":
            # Creation-ordered attributes past 8 move to a fractal heap.
            group = f.create_group("x", track_order=True)
            for k in range(20):
                group.attrs[f"a{k}"] = k
        else:
            f["x"] = np.ones(3)
    expected = {"chunked": "chunked layout", "gzip": "h5lite does not read",
                "r_plus": "opens such files read only",
                "committed_type": "shared \\(committed\\)",
                "dense_attrs": "dense attribute storage"}[kind]
    with pytest.raises(OSError, match=expected):
        with h5lite.File(path, "r+" if kind == "r_plus" else "r") as f:
            np.asarray(f["x"])


_NAMES = st.text("abcxyz019", min_size=1, max_size=4)
_LEAVES = st.one_of(
    st.integers(-2**40, 2**40), st.floats(allow_nan=False), st.booleans(),
    st.text(st.characters(blacklist_categories=("Cs",),
                          blacklist_characters="\x00"), max_size=20),
    st.lists(st.floats(allow_nan=False, width=32), max_size=5).map(
        lambda v: np.asarray(v, np.float32)),
    st.lists(st.integers(-100, 100), min_size=1, max_size=6).map(
        lambda v: np.asarray(v, np.int64)))
_TREES = st.recursive(
    _LEAVES, lambda kids: st.dictionaries(_NAMES, kids, max_size=5),
    max_leaves=12)


@settings(max_examples=15, deadline=None, derandomize=True)
@given(tree=st.dictionaries(_NAMES, _TREES, max_size=5),
       ordered=st.booleans())
def test_random_default_format_trees(tmp_path_factory, tree, ordered):
    path = str(tmp_path_factory.mktemp("hyp0") / "t.h5")

    def write(group, node):
        for name, value in node.items():
            if isinstance(value, dict):
                write(group.create_group(name, track_order=ordered), value)
            else:
                group[name] = value
                group.attrs[name] = value

    with h5py.File(path, "w") as f:
        write(f, tree)
    _assert_same_tree(path)
