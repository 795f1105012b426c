"""The port's offline preprocessors (gnn_rul_tpu_torch/data/) against the
JAX package's on the synthetic raw trees of tests/test_data_{cmapss,
ncmapss,bearing}.py: every array equal, bit for bit, dtypes and dict keys
included, in what each returns and in the .npk files it writes.

The JAX readers parse through pandas and, for the bearing files, through
``gnn_rul_tpu.native``; the native library is pinned to its numpy path
(``_load`` patched to return None, as tests/test_data_bearing.py does),
which test_data_bearing.py holds bit for bit equal to the C++ one, so no
C++ is built here."""

import os

import numpy as np
import pytest

from gnn_rul_tpu import native
from gnn_rul_tpu.data import cmapss as jcmapss
from gnn_rul_tpu.data import ncmapss as jncmapss
from gnn_rul_tpu.data import phm2012 as jphm2012
from gnn_rul_tpu.data import xjtu_sy as jxjtu_sy
from gnn_rul_tpu_torch.data import (cmapss, ncmapss, parse, phm2012,
                                    preprocess, statistics, xjtu_sy)
from gnn_rul_tpu_torch.data.io import load_processed
from test_data_bearing import phm_tree, xjtu_tree  # noqa: F401 (fixtures)
from test_data_cmapss import _write_raw
from test_data_ncmapss import _write_h5


@pytest.fixture(autouse=True)
def numpy_parser(monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)


def assert_same(got, want, where="out"):
    """Equal structure, key types, dtypes and values, bit for bit."""
    if isinstance(want, dict):
        assert isinstance(got, dict), where
        assert list(got) == list(want), where
        for (kg, vg), kw in zip(got.items(), want):
            assert type(kg) is type(kw), f"{where}[{kw!r}]"
            assert_same(vg, want[kw], f"{where}[{kw!r}]")
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.dtype == want.dtype, where
        assert got.shape == want.shape, where
        assert np.array_equal(got, want), (
            f"{where}: max |diff| {np.max(np.abs(got - want))}")
    else:
        assert type(got) is type(want) and got == want, where


def assert_same_artifacts(got_dir, want_dir):
    for split in ("train", "test"):
        assert_same(load_processed(got_dir, split),
                    load_processed(want_dir, split), split)


def _write_cmapss_edges(root):
    """A raw FD001 tree with the cases the generator of test_data_cmapss.py
    leaves out: setting1 values on each side of the one-decimal rounding
    (0.05, 0.15, 0.25, 9.95; -0.004 and 0.004, FD001's, round to -0.0 and
    0.0, one condition), a test condition absent from train, a
    constant sensor (zero range), a train engine shorter than the window
    and a test engine shorter than it."""
    rng = np.random.default_rng(5)
    base = os.path.join(root, "CMAPSSData")
    os.makedirs(base, exist_ok=True)

    def rows(engines, settings):
        out = []
        for eid, n in engines:
            for cyc in range(1, n + 1):
                sensors = rng.uniform(size=21)
                sensors[0] = 518.67
                out.append([eid, cyc, rng.choice(settings), rng.uniform(),
                            0.0] + list(sensors))
        return out

    def save(table, name):
        with open(os.path.join(base, name), "w") as f:
            for r in table:
                f.write(" ".join([str(int(r[0])), str(int(r[1]))]
                                 + [f"{v:.4f}" for v in r[2:]]) + "  \n")

    train = rows([(1, 70), (2, 30), (3, 64)],
                 [0.05, 0.15, 0.25, 9.95, -0.004, 0.004])
    test = rows([(1, 60), (2, 20)], [0.05, 0.25, 42.0])
    rng.shuffle(train)  # the readers sort by (id, cycle)
    save(train, "train_FD001.txt")
    save(test, "test_FD001.txt")
    with open(os.path.join(base, "RUL_FD001.txt"), "w") as f:
        f.write("112 \n7 \n")
    return root


@pytest.mark.parametrize("tree", ["generator", "edges"])
def test_cmapss_equals_jax(tmp_path, tree):
    root = str(tmp_path / "raw")
    if tree == "generator":
        _write_raw(root)
    else:
        _write_cmapss_edges(root)
    out = {side: str(tmp_path / side) for side in ("port", "jax")}
    got = cmapss.preprocess_cmapss(root, "FD001", 125, 50, out["port"])
    want = jcmapss.preprocess_cmapss(root, "FD001", 125, 50, out["jax"])
    assert_same(got, want)
    assert_same_artifacts(os.path.join(out["port"], "CMAPSS", "FD001"),
                          os.path.join(out["jax"], "CMAPSS", "FD001"))
    assert got["train_y"].min() >= 0 and got["train_y"].max() <= 1
    if tree == "edges":
        # 70 - 49 + 64 - 49 windows; engine 2 (30 rows) gives none.
        assert got["train_x"].shape == (36, 50, 14)
        # Test rows of condition 42.0 keep their raw values (> 1).
        assert got["test_x"].max() > 1.0


def test_cmapss_reads_two_trailing_blanks_as_no_column(tmp_path):
    root = _write_raw(str(tmp_path))
    path = os.path.join(root, "CMAPSSData", "train_FD001.txt")
    with open(path) as f:
        assert f.readline().endswith("  \n")
    assert cmapss._read_txt(path).shape[1] == 26


def test_ncmapss_equals_jax(tmp_path):
    root = _write_h5(tmp_path)
    kwargs = dict(window_size=10, stride=1, subsampling=2)
    got = ncmapss.preprocess_ncmapss(root, out_dir=str(tmp_path / "port"),
                                     **kwargs)
    want = jncmapss.preprocess_ncmapss(root, out_dir=str(tmp_path / "jax"),
                                       **kwargs)
    assert_same(got, want)
    assert_same_artifacts(str(tmp_path / "port" / "NCMAPSS"),
                          str(tmp_path / "jax" / "NCMAPSS"))
    assert ncmapss.CHANNELS == jncmapss.CHANNELS


def test_phm2012_equals_jax(phm_tree, tmp_path):  # noqa: F811
    root, _, _ = phm_tree
    got = phm2012.preprocess_phm2012(root, 3, str(tmp_path / "port"), seed=4)
    want = jphm2012.preprocess_phm2012(root, 3, str(tmp_path / "jax"),
                                       seed=4)
    assert_same(got, want)
    assert_same_artifacts(str(tmp_path / "port" / "PHM2012" / "Condition_3"),
                          str(tmp_path / "jax" / "PHM2012" / "Condition_3"))


def _write_phm_condition_1(root, files, sep, ragged=()):
    """A PHM2012 Condition_1 tree of ``files`` (rows, 6) acc files a
    bearing (and a ``temp`` file the readers skip), values separated by
    ``sep[bearing]`` (``","`` where absent); the bearings in ``ragged``
    have a last file one row short."""
    rng = np.random.default_rng(9)
    base = os.path.join(root, "PHM_2012_Bearing_Datasets")
    split = phm2012.TRAIN_TEST_SPLIT
    for folder, names in (("Learning_set", split["Condition1_train"]),
                          ("Test_set", split["Condition1_test"])):
        for name in names:
            d = os.path.join(base, folder, name)
            os.makedirs(d)
            for i in range(files[name]):
                rows = 24 - (name in ragged and i == files[name] - 1)
                mat = np.column_stack([
                    rng.integers(0, 24, size=(rows, 3)),
                    rng.normal(size=(rows, 2)).round(3),
                    rng.integers(0, 9, size=(rows, 1))])
                np.savetxt(os.path.join(d, f"acc_{i + 1:05d}.csv"), mat,
                           fmt="%g", delimiter=sep.get(name, ","))
            np.savetxt(os.path.join(d, "temp_00001.csv"), np.ones((3, 5)),
                       fmt="%g", delimiter=",")
    return root


@pytest.mark.parametrize("ragged", [(), ("Bearing1_2", "Bearing1_6")],
                         ids=["equal files", "ragged files"])
def test_phm2012_condition_1_with_semicolons_equals_jax(tmp_path, ragged):
    files = {"Bearing1_1": 7, "Bearing1_2": 5, "Bearing1_3": 3,
             "Bearing1_4": 4, "Bearing1_5": 2, "Bearing1_6": 3,
             "Bearing1_7": 2}
    root = _write_phm_condition_1(
        str(tmp_path / "raw"), files, {"Bearing1_2": ";", "Bearing1_4": ";"},
        ragged)
    if not ragged:
        # A ';'-separated file parses as a ','-separated one does.
        d = os.path.join(root, "PHM_2012_Bearing_Datasets", "Learning_set",
                         "Bearing1_2")
        with open(os.path.join(d, "acc_00001.csv")) as f:
            assert ";" in f.readline()
        assert phm2012._read_bearing(d).shape == (5, 24)
    else:
        # A bearing whose files differ in length has no (files, rows)
        # block: both packages refuse it.
        for reader in (phm2012, jphm2012):
            with pytest.raises(ValueError):
                reader.preprocess_phm2012(root, 1, str(tmp_path / "x"))
        return
    got = phm2012.preprocess_phm2012(root, 1, str(tmp_path / "port"), seed=1)
    want = jphm2012.preprocess_phm2012(root, 1, str(tmp_path / "jax"),
                                       seed=1)
    assert_same(got, want)
    assert got["max_rul"]["Bearing1_4"] == 4 + 33.9
    assert_same_artifacts(str(tmp_path / "port" / "PHM2012" / "Condition_1"),
                          str(tmp_path / "jax" / "PHM2012" / "Condition_1"))


@pytest.fixture
def port_xjtu_tree(xjtu_tree, monkeypatch):  # noqa: F811
    """The tree of test_data_bearing.py, its shrunken minute counts given
    to the port's table as to the JAX package's."""
    monkeypatch.setattr(xjtu_sy, "RUL_CONDITION_BEARING",
                        jxjtu_sy.RUL_CONDITION_BEARING)
    return xjtu_tree


@pytest.mark.parametrize("downsampling", [1, 2])
def test_xjtu_sy_equals_jax(port_xjtu_tree, tmp_path, downsampling):
    root, _ = port_xjtu_tree
    got = xjtu_sy.preprocess_xjtu_sy(root, 1, downsampling,
                                     str(tmp_path / "port"), seed=2)
    want = jxjtu_sy.preprocess_xjtu_sy(root, 1, downsampling,
                                       str(tmp_path / "jax"), seed=2)
    assert_same(got, want)
    for b in range(1, 6):
        sub = os.path.join("XJTU_SY", "Condition_1", f"Testing_bearing_{b}")
        assert_same_artifacts(str(tmp_path / "port" / sub),
                              str(tmp_path / "jax" / sub))


def test_xjtu_sy_reads_the_column_by_name(tmp_path):
    d = tmp_path / "b"
    d.mkdir()
    mat = np.arange(12, dtype=float).reshape(6, 2) + 0.25
    for i in (1, 2):
        with open(d / f"{i}.csv", "w") as f:
            f.write("Vertical_vibration_signals,"
                    "Horizontal_vibration_signals\n")
            np.savetxt(f, mat * i, fmt="%.17g", delimiter=",")
    got = xjtu_sy._read_bearing(str(d), 2, 1)
    np.testing.assert_array_equal(got, np.stack([mat[:, 1], 2 * mat[:, 1]]))


def test_parse_rounds_as_float_does(tmp_path):
    """Long mantissas parse to the correctly rounded double."""
    text = ["0.1000000000000000055511151231257827", "2.675",
            "1e-320", "-0.30000000000000004", "123456789.123456789"]
    path = tmp_path / "t.csv"
    path.write_text(";".join(text) + "\n" + ",".join(text) + "\n")
    got = parse.read_table(str(path))
    assert got.shape == (2, 5)
    for row in got:
        assert [float(v) for v in row] == [float(t) for t in text]


def test_window_series_skips_short_series():
    a = np.arange(12, dtype=np.float32).reshape(6, 2)
    x, y = parse.window_series([a, a[:2], a[:3]], [np.arange(6), np.arange(2),
                                                   np.arange(3)], 3)
    assert x.shape == (5, 3, 2) and y.shape == (5, 1)
    np.testing.assert_array_equal(y[:, 0], [2, 3, 4, 5, 2])
    np.testing.assert_array_equal(x[4], a[:3])


def test_cli_and_statistics(tmp_path, capsys):
    root = _write_raw(str(tmp_path / "raw"))
    out = str(tmp_path / "out")
    preprocess.main(["--dataset", "CMAPSS", "--data_root", root,
                     "--dataset_id", "FD001", "--out_dir", out])
    want = jcmapss.preprocess_cmapss(root, "FD001", 125, 50,
                                     str(tmp_path / "jax"))
    got = load_processed(os.path.join(out, "CMAPSS", "FD001"), "train")
    assert_same(got["samples"], want["train_x"])
    statistics.describe(os.path.join(out, "CMAPSS", "FD001"))
    printed = capsys.readouterr().out
    assert "CMAPSS preprocessing complete" in printed
    assert f"train_x: {(len(want['train_x']), 14, 50)}" in printed
