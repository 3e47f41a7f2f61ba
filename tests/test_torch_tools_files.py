"""The port's file and checkpoint tools (``ls``, ``cat``, ``cp``, ``split``,
``recordio``, ``rowrec``, ``recompress``, ``dump``, ``ckpt``) against the
JAX package's: the cases of ``tests/test_tools.py`` that cover them, each
run through both packages' ``tools.main`` on the same inputs. The return
codes, stdout and stderr must be equal (with each package's output
directory named alike), and every file the commands wrote byte-equal.
``ckpt`` runs on single-file and sharded ``.d`` checkpoints written by
each package and read by the other; the port's ``.d`` of a placed model
lists and shows its global shapes."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dmlc_core_tpu import tools as jax_tools
from dmlc_core_tpu.checkpoint import Checkpointer as JaxCheckpointer
from dmlc_core_tpu_torch import tools
from dmlc_core_tpu_torch.checkpoint import Checkpointer

REPO = Path(__file__).resolve().parent.parent
TOOLS = {"jax": jax_tools, "port": tools}


def run_cli(mod, argv, capsys):
    rc = mod.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def files_of(d: Path):
    return {str(p.relative_to(d)): p.read_bytes() for p in sorted(d.rglob("*")) if p.is_file()}


def both(tmp_path, capsys, steps):
    """Each argv of ``steps`` (``{in}`` the shared input directory,
    ``{out}`` the package's own output directory) through both packages'
    tools, in order; the runs must agree step by step and leave equal
    files. Returns the port's (rc, stdout, stderr) per step."""
    runs = {}
    for pkg, mod in TOOLS.items():
        out = tmp_path / pkg
        out.mkdir(exist_ok=True)
        runs[pkg] = []
        for argv in steps:
            argv = [a.format(**{"in": str(tmp_path / "in"), "out": str(out)}) for a in argv]
            rc, so, se = run_cli(mod, argv, capsys)
            runs[pkg].append((rc, so.replace(str(out), "{out}"), se.replace(str(out), "{out}")))
    for i, (want, got) in enumerate(zip(runs["jax"], runs["port"])):
        if want[0] == 1:
            # an error: the port's text of a failed check may drop the
            # JAX text's "(reference ...)" note
            want, got = want[:2] + (want[2].split(" (reference")[0].rstrip(),), \
                got[:2] + (got[2].rstrip(),)
        assert got == want, (steps[i], got, want)
    assert files_of(tmp_path / "port") == files_of(tmp_path / "jax")
    return runs["port"]


@pytest.fixture()
def inputs(tmp_path):
    """The JAX tests' libsvm file (40 rows), two small text files and a
    file of lines."""
    d = tmp_path / "in"
    d.mkdir()
    rng = np.random.default_rng(5)
    lines = []
    for i in range(40):
        feats = " ".join(f"{j}:{rng.normal():.4f}" for j in sorted(rng.choice(20, 3, replace=False)))
        lines.append(f"{i % 2} {feats}")
    (d / "train.libsvm").write_text("\n".join(lines) + "\n")
    (d / "a.txt").write_text("hello\n")
    (d / "b.txt").write_text("world\n")
    (d / "lines.txt").write_text("\n".join(f"row-{i}-{'x' * (i % 17)}" for i in range(120)) + "\n")
    (d / "blank.txt").write_text("gamma\n\ndelta\n")
    (d / "x.libsvm").write_text("0.123456789:2.5 qid:7 3 9 12\n1 0:0.25 5:0.5\n")
    (d / "b.libsvm").write_text("1 3 9\n0 2\n")
    (d / "x.libfm").write_text("1 2:30:0.75 4:50\n")
    return d


SVM = "{in}/train.libsvm"
CASES = {
    # test_ls_and_cat_and_cp
    "ls_cat_cp": [["ls", "{in}"], ["ls", "-r", "{in}"], ["cat", "{in}/a.txt"],
                  ["cp", "{in}/a.txt", "{out}/c.txt"]],
    # test_split_shard_counts, test_split_dump_roundtrips_lines
    "split": [["split", SVM, "0", "3"], ["split", SVM, "1", "3"], ["split", SVM, "2", "3"],
              ["split", SVM, "0", "1", "--dump"]],
    # test_recordio_pack_unpack_roundtrip, ..._blank_line_semantics,
    # ..._requires_dst
    "recordio": [["recordio", "pack", "{in}/lines.txt", "{out}/lines.rec"],
                 ["recordio", "unpack", "{out}/lines.rec"],
                 ["recordio", "pack", "{in}/blank.txt", "{out}/blank.rec"],
                 ["recordio", "unpack", "{out}/blank.rec"],
                 ["recordio", "pack", "{in}/a.txt"],
                 ["recordio", "pack", "{in}/lines.txt", "{out}/ix.rec", "--index",
                  "{out}/ix.rec.idx"]],
    # test_rowrec_conversion_feeds_staging, ..._sharded_conversion_covers_exactly
    "rowrec": [["rowrec", SVM, "{out}/d.rec", "--format", "libsvm", "--index",
                "{out}/d.rec.idx"],
               *[["rowrec", SVM, f"{{out}}/s{p}.rec", "--format", "libsvm", "--part", str(p),
                  "--num-parts", "3"] for p in range(3)],
               ["split", "{out}/d.rec", "0", "2", "--type", "recordio"],
               ["split", "{out}/d.rec?index={out}/d.rec.idx", "1", "2", "--type",
                "recordio"]],
    # test_rowrec_codec_feeds_staging
    "rowrec_codec": [["rowrec", SVM, "{out}/d.rec", "--format", "libsvm", "--index",
                      "{out}/d.rec.idx", "--codec", "zlib"],
                     ["dump", "{out}/d.rec"]],
    # test_dump_inverts_rowrec_conversion
    "dump": [["rowrec", SVM, "{out}/d.rec", "--format", "libsvm"], ["dump", "{out}/d.rec"],
             ["dump", "{out}/d.rec", "--limit", "5"],
             ["dump", "{out}/d.rec", "--part", "1", "--num-parts", "2"]],
    # test_dump_fidelity_edge_cases
    "dump_edges": [["dump", "{in}/x.libsvm?format=libsvm"], ["dump", "{in}/b.libsvm?format=libsvm"],
                   ["dump", "{in}/x.libfm?format=libfm"]],
    # test_recordio_pack_codec_and_recompress_roundtrip
    "recompress": [["recordio", "pack", "{in}/lines.txt", "{out}/v1.rec"],
                   ["recompress", "{out}/v1.rec", "{out}/comp.rec", "--codec", "zlib", "--index",
                    "{out}/comp.rec.idx"],
                   ["recompress", "{out}/comp.rec", "{out}/back.rec", "--codec", "none"],
                   ["recompress", "{out}/v1.rec", "{out}/small.rec", "--block-bytes", "256"],
                   ["recordio", "unpack", "{out}/comp.rec"],
                   ["recordio", "pack", "{in}/lines.txt", "{out}/packed.rec", "--codec", "gzip",
                    "--level", "1"],
                   ["recordio", "unpack", "{out}/packed.rec"]],
    # test_error_paths_return_nonzero, test_bad_shard_args_are_cli_errors
    "errors": [["cat", "{in}/missing.txt"],
               ["rowrec", SVM, "{out}/x.rec", "--format", "libsvm", "--num-parts", "0"],
               ["rowrec", SVM, "{out}/x.rec", "--format", "libsvm", "--part", "3",
                "--num-parts", "3"],
               ["rowrec", SVM, "{out}/x.rec", "--format", "libsvm", "--part", "-1"],
               ["split", SVM, "2", "2"]],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_file_commands_match_jax(tmp_path, capsys, inputs, case):
    runs = both(tmp_path, capsys, CASES[case])
    rcs = [rc for rc, _, _ in runs]
    if case == "errors":
        assert rcs == [1] * len(rcs)
        assert all("error:" in err for _, _, err in runs)
        assert all("invalid shard" in err for _, _, err in runs[1:])
    elif case == "recordio":
        assert rcs == [0, 0, 0, 0, 2, 0]
        assert runs[1][1] == (inputs / "lines.txt").read_text()
        assert runs[3][1] == "gamma\ndelta\n"  # a run of newlines is one separator
    else:
        assert rcs == [0] * len(rcs)
    if case == "split":
        assert sum(int(err.split(":")[1].split()[0]) for _, _, err in runs[:3]) == 40
        assert runs[3][1].splitlines() == (inputs / "train.libsvm").read_text().splitlines()
    if case == "dump":
        assert "dumped 40 rows" in runs[1][2] and len(runs[2][1].splitlines()) == 5
        assert len(runs[3][1].splitlines()) == 20


def test_dump_reparses_to_the_same_rows(tmp_path, capsys, inputs):
    """libsvm → rowrec → dump → parse again keeps every row's label,
    indices and values exactly, through the port's parser."""
    from dmlc_core_tpu_torch.data import create_parser

    rec = str(tmp_path / "d.rec")
    assert tools.main(["rowrec", str(inputs / "train.libsvm"), rec, "--format", "libsvm"]) == 0
    rc, out, _ = run_cli(tools, ["dump", rec], capsys)
    assert rc == 0
    (tmp_path / "back.libsvm").write_text(out)

    def rows(uri):
        p = create_parser(uri, threaded=False)
        blocks = list(p)
        p.close()
        return [np.concatenate([getattr(b, k) for b in blocks]).tolist()
                for k in ("label", "index", "value")]

    assert rows(str(inputs / "train.libsvm")) == rows(str(tmp_path / "back.libsvm"))


def save_single(ck_cls, base):
    """The JAX test's three single-file steps, the last with meta."""
    ck = ck_cls(base, keep=10, process_index=0)
    for s in (1, 2, 3):
        ck.save(s, {"w": np.full((4, 2), s, np.float32), "step": s},
                meta={"epoch": s, "records": 64 * s} if s == 3 else None)


CKPT_STEPS = [["ls", "{base}"], ["show", "{base}"], ["show", "{base}", "--step", "1"],
              ["show", "{base}", "--step", "9"], ["prune", "{base}", "--keep", "0"],
              ["prune", "{base}", "--keep", "2"], ["ls", "{base}"]]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ckpt_single_layout_both_ways(tmp_path, capsys, writer):
    """``ckpt ls|show|prune`` as in ``test_ckpt_ls_show_prune``, on steps
    one package wrote, read by both packages' tools (each on a copy, as
    prune removes steps): the outputs are equal, and as the JAX test
    expects them."""
    outs = {}
    for reader, mod in TOOLS.items():
        base = str(tmp_path / reader / "cks")
        save_single(JaxCheckpointer if writer == "jax" else Checkpointer, base)
        capsys.readouterr()  # the saves' log lines, stamped with the time
        outs[reader] = [run_cli(mod, ["ckpt", a, *(x.format(base=base) for x in rest)], capsys)
                        for a, *rest in CKPT_STEPS]
        outs[reader] = [(rc, so.replace(base, "{base}"), se.replace(base, "{base}"))
                        for rc, so, se in outs[reader]]
    assert outs["port"] == outs["jax"]
    got = outs["port"]
    listing = json.loads(got[0][1])
    assert [e["step"] for e in listing] == [1, 2, 3]
    assert all(e["layout"] == "single" and e["bytes"] > 0 for e in listing)
    shown = json.loads(got[1][1])
    assert shown["step"] == 3 and shown["tree"]["w"] == "float32[4, 2]"
    assert shown["meta"] == {"epoch": 3, "records": 192}
    assert "meta" not in json.loads(got[2][1])
    assert got[3][0] == 1 and "error:" in got[3][2] and "step 9" in got[3][2]
    assert json.loads(got[4][1]) == {"kept": [1, 2, 3], "removed": []}
    assert json.loads(got[5][1]) == {"kept": [2, 3], "removed": [1]}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ckpt_sharded_layout_both_ways(tmp_path, capsys, writer):
    """A sharded ``.d`` step written by either package lists as
    ``sharded`` and shows its shapes through both packages' tools alike;
    a base with no step is an error naming no ``None``."""
    base = str(tmp_path / "cks")
    (JaxCheckpointer if writer == "jax" else Checkpointer)(base, sharded=True).save(
        7, {"w": np.ones(6, np.float32)})
    capsys.readouterr()  # the JAX save's log line
    outs = {reader: [run_cli(mod, ["ckpt", a, base], capsys) for a in ("ls", "show")]
            for reader, mod in TOOLS.items()}
    assert outs["port"] == outs["jax"]
    (entry,) = json.loads(outs["port"][0][1])
    assert entry["layout"] == "sharded" and entry["step"] == 7
    assert json.loads(outs["port"][1][1])["tree"]["w"] == "float32[6]"
    empty = str(tmp_path / "empty")
    got = [run_cli(mod, ["ckpt", "show", empty], capsys) for mod in TOOLS.values()]
    assert got[0] == got[1] and got[1][0] == 1 and "None" not in got[1][2]


def test_ckpt_of_a_placed_model_as_a_subprocess(tmp_path):
    """``python -m dmlc_core_tpu_torch.tools ckpt ls|show`` on the ``.d``
    of an FM placed on a mesh of one rank, saved with meta: the listing
    is ``Checkpointer.steps_info()``, the tree the global shapes."""
    import torch

    from dmlc_core_tpu_torch.models import FactorizationMachine
    from dmlc_core_tpu_torch.parallel import P, make_mesh, place_model

    mesh = make_mesh(device="cpu")
    model = FactorizationMachine(64, 8, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    place_model(model, mesh, {"v": P(None, "data")})
    base = str(tmp_path / "ck")
    ck = Checkpointer(base, sharded=True)
    ck.save(5, model.placed(), meta={"batches": 5})
    assert ck.steps_info()[0]["layout"] == "sharded"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    run = [subprocess.run([sys.executable, "-m", "dmlc_core_tpu_torch.tools", "ckpt", a, base],
                          capture_output=True, text=True, timeout=120, env=env, cwd=str(tmp_path))
           for a in ("ls", "show")]
    assert [r.returncode for r in run] == [0, 0], [r.stderr for r in run]
    assert json.loads(run[0].stdout) == ck.steps_info()
    shown = json.loads(run[1].stdout)
    assert shown == {"step": 5, "tree": {"b": "float32[]", "v": "float32[64, 8]",
                                         "w": "float32[64]"},
                     "meta": {"batches": 5}}


def test_module_entrypoint_lists_the_commands():
    proc = subprocess.run([sys.executable, "-m", "dmlc_core_tpu_torch.tools", "--help"],
                          capture_output=True, text=True, timeout=60, cwd=str(REPO))
    assert proc.returncode == 0
    for cmd in ("ls", "cat", "cp", "split", "recordio", "rowrec", "recompress", "dump", "ckpt"):
        assert cmd in proc.stdout
