"""Coverage for the remaining harness surfaces: .txt loader, the second
(BCOO) incumbent baseline, and the profile-CSV reducer."""

import numpy as np

from tcgnn.data import dataset as data_lib


def test_load_txt_roundtrip(tmp_path):
    """Two-ints-per-line edge list (the reference's .txt contract,
    dataset.py:47-66)."""
    edges = np.array([[0, 1], [1, 0], [1, 2], [2, 1], [3, 0], [0, 3]])
    p = tmp_path / "tiny.txt"
    np.savetxt(p, edges, fmt="%d")
    ds = data_lib.load_txt(str(p), dim=8, num_classes=2)
    assert ds.num_nodes == 4 and ds.num_edges == 6
    assert ds.x.shape == (4, 8)
    # CSR row 0 holds neighbors {1, 3}
    r0 = ds.column_index[ds.row_pointers[0] : ds.row_pointers[1]]
    assert set(r0.tolist()) == {1, 3}


def test_bcoo_baseline_runs_and_reports(capsys):
    """The second incumbent (jax.experimental.sparse BCOO) stays live:
    same CLI/output contract as the gather baseline."""
    from tcgnn.bench import baseline

    ms = baseline.main([
        "--dataset", "rand_500_2500", "--dim", "8", "--classes", "3",
        "--hidden", "8", "--epochs", "3", "--model", "gcn",
        "--impl", "bcoo",
    ])
    out = capsys.readouterr().out
    assert ms is not None and ms > 0
    assert "Train (ms)" in out


def test_proc_prof_reduces_csvs(tmp_path, capsys):
    from tcgnn.bench import proc_prof

    p1 = tmp_path / "a.csv"
    p1.write_text(
        "dataset,Avg.Epoch (ms)\ncora,2.0\npubmed,4.0\n"
    )
    p2 = tmp_path / "b.csv"
    p2.write_text(
        "dataset,Avg.Epoch (ms)\ncora,4.0\npubmed,8.0\n"
    )
    columns, by_key = proc_prof.reduce_csvs([str(p1), str(p2)])
    assert columns == ["Avg.Epoch (ms)"]
    assert by_key[("cora", "Avg.Epoch (ms)")] == [2.0, 4.0]
    assert np.mean(by_key[("pubmed", "Avg.Epoch (ms)")]) == 6.0


def test_epoch_ledger_smoke(tmp_path):
    """Measured per-stage epoch ledger: stages are measured, summed, and
    the CSV row carries the decomposition (methodology harness; CPU times
    say nothing about the device)."""
    from tcgnn.bench import epoch_ledger as E

    out = tmp_path / "ledger.csv"
    rows = E.main([
        "--datasets", "rand_1500_9000", "--epochs", "12",
        "--dtype", "float32", "--reorder", "none", "--out", str(out),
    ])
    assert len(rows) == 1
    r = rows[0]
    assert r["epoch_ms"] > 0 and r["dense_rest_ms"] > 0
    assert len(r["agg_stages"]) >= 3  # L1 fwd + L2 fwd + L2 bwd
    assert abs(r["stage_sum_ms"] - (
        r["dense_rest_ms"] + r["agg_ms"]
    )) < 1e-6
    header = out.read_text().splitlines()[0]
    assert header.startswith("dataset,epoch_ms")
