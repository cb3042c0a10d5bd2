"""The tools' variant builder (``safe_grid_agents_torch/tools/variants.py``)
on the CPU: every variant tool's substitutions still match the package's
sources, and ``build`` starts one compiler a source, waits for all of
them, and raises with the output of each one that failed. A stub compiler
(a Python script that writes the ``-o`` file) stands in for nvcc, so
these run without the CUDA toolkit; the libraries themselves are built and
loaded on a card host only.
"""
import sys
import types

import pytest

from safe_grid_agents_torch.ops import _build
from safe_grid_agents_torch.tools import (
    ab_rollout, b2_variants, b9_variants, b11_variants, grid_variants, variants,
)

STUB = r'''import sys
args = sys.argv[1:]
out, src = args[args.index("-o") + 1], args[-1]
text = open(src).read()
inc = [args[i + 1] for i, a in enumerate(args) if a == "-I"]
print("ptxas info    : Used 12 registers, 360 bytes cmem[0]")
print("include", " ".join(inc))
if "FAIL" in text:
    print("error: FAIL in", src)
    sys.exit(2)
open(out, "w").write(text)
'''


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    path = tmp_path / "nvcc"
    path.write_text(f"#!{sys.executable}\n{STUB}")
    path.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(path))
    return path


def test_build_compiles_every_source_with_the_package_flags(tmp_path, stub_nvcc):
    srcs = {}
    for label in ("as built", "chain only"):
        cu = tmp_path / "src" / variants.slug(label) / "k.cu"
        cu.parent.mkdir(parents=True)
        cu.write_text(f"// {label}\n")
        srcs[label] = cu
    built = variants.build(srcs, tmp_path / "out")
    assert list(built) == ["as built", "chain only"]
    for label, b in built.items():
        assert b.so == tmp_path / "out" / f"lib{variants.slug(label)}.so"
        assert b.so.read_text() == f"// {label}\n"
        assert variants.registers(b.report) == ["Used 12 registers, 360 bytes cmem[0]"]
        # the source's own directory first, so headers beside a variant win
        assert f"include {srcs[label].parent} {_build.CSRC}" in b.report
        assert b.sass is None and b.digest is None


def test_build_raises_with_every_failed_output(tmp_path, stub_nvcc):
    srcs = {}
    for label, text in (("good", "ok"), ("bad one", "FAIL"), ("bad two", "FAIL")):
        srcs[label] = tmp_path / f"{variants.slug(label)}.cu"
        srcs[label].write_text(text)
    with pytest.raises(RuntimeError) as err:
        variants.build(srcs, tmp_path / "out")
    msg = str(err.value)
    assert "variant bad one" in msg and "variant bad two" in msg and "variant good" not in msg
    assert (tmp_path / "out" / "libgood.so").exists()  # every compiler was waited for


def test_write_variants_checks_every_change_before_writing(tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("x = 1; y = 2;\n")
    (csrc / "h.cuh").write_text("#define N 4\n")
    paths = variants.write_variants(
        ["a.cu", "h.cuh"], {"as built": [], "n8": [("h.cuh", "N 4", "N 8")],
                            "both": [("a.cu", "x = 1", "x = 3"), ("h.cuh", "N 4", "N 8")]},
        tmp_path / "out", csrc=csrc)
    assert paths["as built"]["a.cu"].read_text() == "x = 1; y = 2;\n"
    assert paths["n8"]["h.cuh"].read_text() == "#define N 8\n"
    assert paths["n8"]["a.cu"].read_text() == "x = 1; y = 2;\n"
    assert paths["both"]["a.cu"].read_text() == "x = 3; y = 2;\n"
    assert len({p["a.cu"].parent for p in paths.values()}) == 3  # a directory each
    with pytest.raises(ValueError, match="no longer holds 'z = 9'"):
        variants.write_variants(["a.cu"], {"gone": [("a.cu", "z = 9", "z = 0")]},
                                tmp_path / "out2", csrc=csrc)
    assert not (tmp_path / "out2").exists()


def test_swapped_restores_the_entry_point():
    mod = types.SimpleNamespace(_fn="own")
    with pytest.raises(KeyError):
        with variants.swapped(mod, _fn="variant"):
            assert mod._fn == "variant"
            raise KeyError
    assert mod._fn == "own"


@pytest.mark.parametrize("tool", ["ab_rollout", "b2_variants", "b9_variants", "b11_variants",
                                  "grid_variants"])
def test_variant_tools_still_match_the_sources(tool, tmp_path):
    """Each variant tool's substitutions still match the package's sources,
    the first variant is the source unchanged and no two variants are the
    same text."""
    if tool == "ab_rollout":
        paths = ab_rollout.part_sources(_build.CSRC / "rollout_kernel.cu", tmp_path)
    else:
        paths = {"b2_variants": b2_variants, "b9_variants": b9_variants,
                 "b11_variants": b11_variants,
                 "grid_variants": grid_variants}[tool].variant_sources(tmp_path)
    files = {name: p if isinstance(p, dict) else {p.name: p} for name, p in paths.items()}
    texts = [tuple(p.read_text() for p in f.values()) for f in files.values()]
    first = next(iter(files.values()))
    assert texts[0] == tuple((_build.CSRC / name).read_text() for name in first)
    assert len(set(texts)) == len(texts)
