"""The port's corpus harness (bench/harness.py) and comparison table
(bench/compare.py) on the CPU, at two small corpus files, against the JAX
package's harness and oracles."""

import json

import pytest

from cpprcoder_tpu.bench import harness as jharness
from cpprcoder_tpu.codecs import get_codec as jget_codec
from cpprcoder_tpu.codecs.pipeline import pipeline_encode as jpipeline_encode
from cpprcoder_tpu_torch.bench import compare, harness

FILES = ["grammar.lsp", "xargs.1"]


@pytest.mark.parametrize("codec, where", [
    ("rcq", {"device": "cpu"}), ("rcx", {"backend": "ref"}),
    ("adaptive_o1", {"device": "cpu"}), ("slz4", {"backend": "native"})])
def test_run_codec_rows(codec, where):
    """Each file round-trips, and its size is the JAX package's oracle's
    container (the "ref" backend): the same rows as the JAX harness but
    for the times."""
    agg = harness.run_codec(codec, files=FILES, repeats=1, warmup=False,
                            **where)
    assert agg["codec"] == codec and agg["all_roundtrip_ok"]
    assert [r["file"] for r in agg["files"]] == FILES
    for r in agg["files"]:
        data = harness.load(r["file"])
        want = len(jget_codec(codec).encode(data, backend="ref"))
        assert r["bytes"] == len(data) and r["compressed"] == want
        assert r["ratio"] == want / len(data)
        assert r["enc_MBps"] > 0 and r["dec_MBps"] > 0
        assert r["ref_ratio"] == jharness.REF_RATIOS.get(codec, {}).get(
            r["file"])
    assert agg["total_bytes"] == sum(len(harness.load(f)) for f in FILES)
    assert "| **total** |" in harness.markdown_table(agg)


def test_run_external_rows():
    assert harness.external_names() == jharness.external_names()
    for name in harness.external_names():
        agg = harness.run_external(name, files=FILES, repeats=1)
        want = jharness.run_external(name, files=FILES, repeats=1)
        assert agg["all_roundtrip_ok"]
        assert [(r["file"], r["compressed"]) for r in agg["files"]] == \
            [(r["file"], r["compressed"]) for r in want["files"]]


def test_main_prints_json_rows(capsys):
    harness.main(["rans", "zlib", "--json", "--files", *FILES,
                  "--device", "cpu"])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["codec"] for r in rows] == ["rans", "zlib"]
    assert all(r["all_roundtrip_ok"] for r in rows)


def test_main_without_silesia_reports_it(capsys, monkeypatch, tmp_path):
    monkeypatch.setenv("CT_SILESIA_DIR", str(tmp_path))
    assert harness.silesia_files() == []
    harness.main(["rans", "--corpus", "silesia", "--device", "cpu"])
    assert "silesia corpus not present" in capsys.readouterr().out


def test_compare_build_written_to_tmp_path(tmp_path):
    """build() over two codecs and the pipeline, written where --out names
    it; the ratios are the JAX package's oracle containers'."""
    out = tmp_path / "cmp"
    compare.main(["--out", str(out), "--codecs", "rcq", "huffman",
                  "--files", *FILES, "--backend", "ref"])
    d = json.loads((tmp_path / "cmp.json").read_text())
    md = (tmp_path / "cmp.md").read_text()
    assert d["files"] == FILES and set(d["ct"]) == {"rcq", "huffman",
                                                    "bwt_pipeline"}
    for f in FILES:
        data = harness.load(f)
        for codec in ("rcq", "huffman"):
            want = len(jget_codec(codec).encode(data, backend="ref"))
            assert d["ct"][codec][f] == {"ratio": round(want / len(data), 5),
                                         "roundtrip_ok": True}
        want = len(jpipeline_encode(data, stages=compare.PIPELINES[
            "bwt_pipeline"], backend="ref"))
        assert d["ct"]["bwt_pipeline"][f]["ratio"] == round(want / len(data),
                                                            5)
    assert set(d["external"]) == set(harness.external_names())
    assert md.startswith("# Ratio comparison") and "| grammar.lsp |" in md
    assert md == compare.to_markdown(d)


def test_compare_never_writes_the_jax_packages_table():
    for out in (compare.ROOT / "COMPARISON", "COMPARISON"):
        if out == "COMPARISON" and compare.ROOT.resolve() != \
                compare.Path.cwd().resolve():
            continue
        with pytest.raises(SystemExit, match="JAX package"):
            compare.out_paths(str(out))
