"""The port's CLI (python -m cpprcoder_tpu_torch.cli) against the JAX
package's (python -m cpprcoder_tpu.cli), on the CPU, at grammar.lsp and
xargs.1: the same containers, each decoding the other's, the same codec
list, no CPU fallback without --device, and nothing of JAX loaded."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cpprcoder_tpu import cli as jcli
from cpprcoder_tpu import debug as jdebug
from cpprcoder_tpu.codecs.pipeline import make_pipeline as jmake_pipeline
from cpprcoder_tpu_torch import cli, debug
from cpprcoder_tpu_torch.codecs.pipeline import make_pipeline

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "data"
PIPE = ["blocksort", "mtf1", "rle0", "adaptive_range"]


@pytest.fixture(autouse=True)
def _shadow_off():
    """The JAX CLI leaves its shadow switch on; the port's CLI restores
    its own (held here)."""
    yield
    assert not debug.shadow_enabled()
    jdebug.set_shadow(False)


def _compress(main, tmp_path, tag, infile, *args) -> bytes:
    out = tmp_path / f"{tag}.ct"
    assert main(["compress", *args, str(infile), str(out)]) == 0
    return out.read_bytes()


@pytest.mark.parametrize("codec", ["rans", "rcx", "rcq", "huffman",
                                   "adaptive_o1", "adaptive_rans", "ase",
                                   "slz4", "static_range"])
@pytest.mark.parametrize("name", ["grammar.lsp", "xargs.1"])
def test_containers_equal_the_jax_clis(tmp_path, codec, name):
    """--backend ref in both CLIs writes the same container; the port's
    CPU path (--device cpu) writes it too."""
    mine = _compress(cli.main, tmp_path, "port", DATA / name, "-c", codec,
                     "--backend", "ref")
    theirs = _compress(jcli.main, tmp_path, "jax", DATA / name, "-c", codec,
                       "--backend", "ref")
    assert mine == theirs
    if codec in ("rans", "rcq", "huffman", "static_range"):
        assert _compress(cli.main, tmp_path, "cpu", DATA / name, "-c", codec,
                         "--device", "cpu") == theirs


def test_container_equals_the_jax_backends(tmp_path):
    """The JAX CLI's own backend ("jax") and the port's CPU path."""
    args = ["-c", "rcq"]
    assert (_compress(cli.main, tmp_path, "port", DATA / "xargs.1", *args,
                      "--device", "cpu")
            == _compress(jcli.main, tmp_path, "jax", DATA / "xargs.1", *args,
                         "--backend", "jax"))


@pytest.mark.parametrize("how", ["codec", "stages"])
def test_each_decodes_the_others_output(tmp_path, how):
    """A codec's container (rcx) and a --stages pipeline's (blocksort mtf1
    rle0 adaptive_range): the port decodes the JAX CLI's output and the
    JAX CLI the port's."""
    src = DATA / "xargs.1"
    enc = ["-c", "rcx"] if how == "codec" else ["--stages", *PIPE]
    dec = ["-c", "rcx"] if how == "codec" else ["--stages"]
    port = tmp_path / "port.ct"
    jax_ = tmp_path / "jax.ct"
    assert cli.main(["compress", *enc, "--device", "cpu", str(src),
                     str(port)]) == 0
    assert jcli.main(["compress", *enc, "--backend", "ref", str(src),
                      str(jax_)]) == 0
    assert port.read_bytes() == jax_.read_bytes()
    for main, blob, opts in ((cli.main, jax_, ["--device", "cpu"]),
                             (jcli.main, port, ["--backend", "ref"])):
        out = tmp_path / "rt.bin"
        assert main(["decompress", *dec, *opts, str(blob), str(out)]) == 0
        assert out.read_bytes() == src.read_bytes()


def test_make_pipeline_equals_the_jax_packages():
    """make_pipeline binds the stages; backend and device pass through."""
    data = (DATA / "xargs.1").read_bytes()
    enc, dec = make_pipeline(PIPE)
    jenc, jdec = jmake_pipeline(PIPE)
    blob = enc(data, device="cpu")
    assert blob == jenc(data, backend="ref") == enc(data, backend="ref")
    assert dec(blob, device="cpu") == jdec(blob, backend="ref") == data
    with pytest.raises(ValueError, match="backend 'torch'"):
        enc(data, backend="torch", device="meta")


def test_profile_and_shadow(tmp_path, capsys):
    src = DATA / "grammar.lsp"
    blob = tmp_path / "g.ct"
    assert cli.main(["compress", "-c", "rcq", "--device", "cpu", "--profile",
                     "--shadow", str(src), str(blob)]) == 0
    err = capsys.readouterr().err
    for name in ("enc.scan", "enc.materialize", "enc.assemble"):
        assert f"| {name} |" in err
    assert cli.main(["decompress", "-c", "rcq", "--device", "cpu",
                     "--profile", str(blob), str(tmp_path / "g.out")]) == 0
    assert "| dec.scan |" in capsys.readouterr().err
    assert (tmp_path / "g.out").read_bytes() == src.read_bytes()


def test_list_equals_the_jax_clis(capsys):
    assert cli.main(["list"]) == 0
    mine = capsys.readouterr().out
    assert jcli.main(["list"]) == 0
    assert mine == capsys.readouterr().out and "rcx" in mine.split()


def test_bench_rows(capsys):
    assert cli.main(["bench", "-c", "rans", "--files", "grammar.lsp",
                     "--json", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert '"all_roundtrip_ok": true' in out and '"codec": "rans"' in out


def test_no_device_and_no_card_exits_non_zero(tmp_path):
    """Without --device the codecs run on the card; with none the command
    fails with resolve's error, never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    out = subprocess.run(
        [sys.executable, "-m", "cpprcoder_tpu_torch.cli", "compress", "-c",
         "rans", str(DATA / "grammar.lsp"), str(tmp_path / "g.ct")],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert not (tmp_path / "g.ct").exists()


def test_cli_run_loads_nothing_of_jax(tmp_path):
    code = f"""
import sys
from cpprcoder_tpu_torch import cli, debug
src, blob, out = {str(DATA / 'xargs.1')!r}, {str(tmp_path / 'x.ct')!r}, \\
    {str(tmp_path / 'x.out')!r}
assert cli.main(["compress", "--stages", "blocksort", "mtf1", "rle0",
                 "adaptive_range", "--device", "cpu", "--shadow",
                 "--profile", src, blob]) == 0
assert cli.main(["decompress", "--stages", "--device", "cpu", blob,
                 out]) == 0
assert open(out, "rb").read() == open(src, "rb").read()
assert cli.main(["list"]) == 0
assert cli.main(["bench", "-c", "rcq", "zlib", "--files", "xargs.1",
                 "--device", "cpu"]) == 0
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "cpprcoder_tpu"
             or m.startswith("cpprcoder_tpu."))
print("BAD", bad)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1] == "BAD []"
