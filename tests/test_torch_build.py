"""Building the port's kernels from several threads of one process at once
(the servers of a fleet reaching a cold ``build/`` together): one compiler
run per source, an intact library, one load and one binding.  The compiler
is a fake script, so this runs on any machine; nothing is loaded on a card."""

import os
import stat
import threading

import pytest

from repro_torch.kernels import _build

FAKE_NVCC = """#!/bin/sh
# records its call, then writes the source into the output in two halves
# with a pause between them, so a second writer of the same path would
# leave a file that is not the source
echo "$$" >> "{calls}"
out=""
src=""
while [ $# -gt 0 ]; do
  case "$1" in
    -o) out="$2"; shift ;;
    *.cu) src="$1" ;;
  esac
  shift
done
head -c 4096 "$src" > "$out"
sleep 0.3
tail -c +4097 "$src" >> "$out"
"""


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    sources = {}
    for i, (name, file) in enumerate(_build.SOURCES.items()):
        text = "".join(f"// {name} line {j} {'x' * (i + 7)}\n"
                       for j in range(400))
        (csrc / file).write_text(text)
        sources[name] = text
    calls = tmp_path / "calls.txt"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(calls=calls))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "build_dir", lambda: out)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_LIBS", {})
    return sources, calls, out


def _together(n, fn):
    barrier, errors, results = threading.Barrier(n), [], []

    def run():
        barrier.wait()
        try:
            results.append(fn())
        except Exception as e:          # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    return results


@pytest.mark.parametrize("names", [["banked"], None])
def test_concurrent_builds_run_one_compiler_per_source(fake_toolchain,
                                                       names):
    sources, calls, out = fake_toolchain
    results = _together(6, lambda: _build.build(names))
    want = list(sources) if names is None else names
    assert len(calls.read_text().split()) == len(want)
    for paths in results:
        assert sorted(paths) == sorted(want)
    for name in want:
        lib = results[0][name]
        assert all(r[name] == lib for r in results)
        assert lib.read_text() == sources[name], f"{name}: not intact"
    assert sorted(os.listdir(out)) == sorted(
        results[0][n].name for n in want), "a temporary file was left"


def test_concurrent_loads_bind_one_library_once(fake_toolchain,
                                                monkeypatch):
    sources, calls, _ = fake_toolchain
    opened, bound = [], []

    class FakeCDLL:
        def __init__(self, path):
            opened.append(path)

    monkeypatch.setattr(_build.ctypes, "CDLL", FakeCDLL)
    libs = _together(6, lambda: _build.load("moe_dispatch", bound.append))
    assert len(calls.read_text().split()) == 1
    assert len(opened) == 1 and len(bound) == 1
    assert all(lib is libs[0] for lib in libs) and bound[0] is libs[0]


def test_temporary_name_holds_the_process_and_the_thread(fake_toolchain,
                                                         monkeypatch):
    """Two processes sharing ``build/`` each write their own temporary
    file: its name carries the pid and the thread."""
    seen = []
    real = _build.subprocess.Popen

    def popen(cmd, **kw):
        seen.append(cmd[cmd.index("-o") + 1])
        return real(cmd, **kw)

    monkeypatch.setattr(_build.subprocess, "Popen", popen)
    _build.build(["ssd_chunk"])
    assert len(seen) == 1
    assert f".tmp{os.getpid()}-{threading.get_ident()}." in seen[0]


def test_every_source_lies_in_csrc():
    """Each registered kernel source is in the package, and each library
    is named by a hash of its own source."""
    assert "decode_attention" in _build.SOURCES
    for file in _build.SOURCES.values():
        assert (_build.CSRC / file).is_file(), file
    names = {_build._lib_path(n).name for n in _build.SOURCES}
    assert len(names) == len(_build.SOURCES)
