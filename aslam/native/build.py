"""Build the native library: `python -m aslam.native.build`."""

from __future__ import annotations

import os
import subprocess
import sys


def build(verbose: bool = True) -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    srcs = [os.path.join(here, "png_loader.cpp"),
            os.path.join(here, "prefetcher.cpp")]
    out = os.path.join(here, "libaslam_native.so")
    cmd = [
        "g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-pthread",
        *srcs, "-o", out, "-lz",
    ]
    if verbose:
        print("+", " ".join(cmd))
    subprocess.run(cmd, check=True)
    return out


if __name__ == "__main__":
    path = build()
    print("built", path)
    sys.exit(0)
