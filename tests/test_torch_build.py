"""Two processes building the port's native library or kernels at once.

Each process finds the output missing at the same moment (a barrier of
marker files lines them up) and runs the port's own build step, with the
compiler replaced by a stub that sleeps, counts its runs and writes the
output.  Both must end with one intact output, the stub must have run
once (the second process reuses the first one's build), and no temporary
file may be left behind.
"""

import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_STUB_NVCC = textwrap.dedent("""\
    #!{python}
    import sys, time
    args = sys.argv[1:]
    out, src = args[args.index("-o") + 1], args[-1]
    time.sleep(1.0)
    with open({count!r}, "a") as f:
        f.write("x")
    with open(out, "w") as f:
        f.write(open(src).read())
""")

_STUB_MAKEFILE = textwrap.dedent("""\
    LIB := libtorchft_tpu_native.so
    all: $(LIB)
    $(LIB): a.cc
    \tsleep 1; printf x >> count; cp a.cc $@
""")

_DRIVER = textwrap.dedent("""\
    import os, sys, time
    sys.path.insert(0, {repo!r})
    kind, work, me = sys.argv[1], sys.argv[2], sys.argv[3]
    if kind == "kernels":
        from torchft_tpu_torch import _kernels as k
        k.CSRC_DIR = os.path.join(work, "csrc")
        k.BUILD_DIR = os.path.join(work, "build")
        k.KERNELS = {{"a": ("a.cu", "tft_a", [])}}
        k._nvcc = lambda: os.path.join(work, "nvcc")
        build = lambda: k.build(["a"])
    else:
        from torchft_tpu_torch import _native as n
        n._NATIVE_DIR = work
        build = n._find_lib
    open(os.path.join(work, "ready" + me), "w").close()
    while not all(os.path.exists(os.path.join(work, "ready" + i)) for i in "01"):
        time.sleep(0.01)
    build()
""")


@pytest.mark.parametrize("kind", ["kernels", "native"])
def test_concurrent_builds_leave_one_intact_output(tmp_path, kind):
    work = tmp_path
    source = "intact output " * 100
    if kind == "kernels":
        (work / "csrc").mkdir()
        (work / "csrc" / "a.cu").write_text(source)
        nvcc = work / "nvcc"
        nvcc.write_text(_STUB_NVCC.format(python=sys.executable,
                                          count=str(work / "count")))
        nvcc.chmod(0o755)
        out_dir, out_name = work / "build", "libtft_a.so"
    else:
        (work / "a.cc").write_text(source)
        (work / "Makefile").write_text(_STUB_MAKEFILE)
        out_dir, out_name = work, "libtorchft_tpu_native.so"
    driver = work / "driver.py"
    driver.write_text(_DRIVER.format(repo=REPO))
    procs = [
        subprocess.Popen([sys.executable, str(driver), kind, str(work), me],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for me in "01"
    ]
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out.decode()[-2000:]
    assert (out_dir / out_name).read_text() == source
    assert (work / "count").read_text() == "x"
    assert not [n for n in os.listdir(out_dir) if ".tmp" in n]
