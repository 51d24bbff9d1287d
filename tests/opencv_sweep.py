"""A sweep of corrupt files against OpenCV itself (not a tier-1 test): the
port's OpenCV route (vpt_tpu_torch/io/opencv.py) against
`cv2.imreadmulti(path, 0, 1, IMREAD_COLOR)` then BGR -> RGB, as imageio's
plugin calls it, on mutants (tests/opencv_cases.mutants) of every file of
tests/torch_opencv/ (but the corrupt copies of earlier sweeps kept there)
and of the format, WebP and JPEG 2000 cases of
tests/format_cases.py, tests/webp_cases.py and tests/jpeg2000_cases.py.
A mutant agrees where both read the same array or both fail.  OpenCV runs
in a worker process that is restarted where a mutant crashes it (such a
mutant counts as OpenCV failing).  Prints the counts by format as JSON.

    python tests/opencv_sweep.py [MUTANTS_PER_FILE] [SEED] [OUT_DIR]

With OUT_DIR, each differing mutant is written there as FORMAT-FILE-K (the
index of its source file and of the mutant), to be made a fixture of
tests/opencv_cases.py.
"""

from __future__ import annotations

import collections
import json
import os
import pickle
import struct
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from opencv_cases import mutants  # noqa: E402
from vpt_tpu_torch.io import opencv  # noqa: E402

_WORKER = r"""
import pickle, struct, sys, cv2
inp, out = sys.stdin.buffer, sys.stdout.buffer
while True:
    head = inp.read(4)
    if len(head) < 4:
        break
    path = inp.read(struct.unpack("<I", head)[0]).decode()
    try:
        ok, img = cv2.imreadmulti(path, 0, 1, flags=cv2.IMREAD_COLOR)
        res = (img[0][..., ::-1].copy() if img[0].ndim == 3 else img[0]) if ok else None
    except cv2.error:
        res = None
    b = pickle.dumps(res)
    out.write(struct.pack("<I", len(b)) + b)
    out.flush()
"""


class OpenCV:
    """cv2 in a worker process, restarted after a crash."""

    def __init__(self):
        self.proc = None
        self.dir = tempfile.mkdtemp()

    def read(self, data: bytes):
        if self.proc is None or self.proc.poll() is not None:
            self.proc = subprocess.Popen([sys.executable, "-c", _WORKER], stdin=subprocess.PIPE,
                                         stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
        path = os.path.join(self.dir, "x")
        with open(path, "wb") as f:
            f.write(data)
        b = path.encode()
        self.proc.stdin.write(struct.pack("<I", len(b)) + b)
        self.proc.stdin.flush()
        head = self.proc.stdout.read(4)
        if len(head) < 4:
            self.proc = None
            return None
        return pickle.loads(self.proc.stdout.read(struct.unpack("<I", head)[0]))


def files() -> list:
    """(format, bytes) of every file the sweep mutates."""
    out = []
    folder = os.path.join(HERE, "torch_opencv")
    for name in sorted(os.listdir(folder)):
        if name != "manifest.json" and not name.startswith("sweep-"):  # (those are corrupt copies already)
            with open(os.path.join(folder, name), "rb") as f:
                out.append((name.split("-")[0], f.read()))
    import format_cases
    import jpeg2000_cases
    import webp_cases

    for name, (ext, _) in format_cases.CASES.items():
        if ext in (".tif", ".gif", ".bmp", ".jpg"):
            out.append((ext[1:], format_cases.case_bytes(name)))
    out += [("webp", webp_cases.case_bytes(n)) for n in webp_cases.CASES]
    out += [("j2k", jpeg2000_cases.case_bytes(n)) for n in jpeg2000_cases.CASES]
    return out


def main() -> None:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 22
    out_dir = sys.argv[3] if len(sys.argv) > 3 else None
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    cv = OpenCV()
    counts = collections.defaultdict(collections.Counter)
    for i, (fmt, data) in enumerate(files()):
        for k, m in enumerate(mutants(data, seed + i, n)):
            if opencv.decoder(m) is None:
                counts[fmt]["not claimed"] += 1
                continue
            want = cv.read(m)
            try:
                got = opencv.read(m, "x")
            except ValueError:
                got = None
            if want is None or got is None:
                key = "agree (both fail)" if want is None and got is None else "differ"
            else:
                key = "agree (equal)" if want.shape == got.shape and np.array_equal(want, got) else "differ"
            counts[fmt][key] += 1
            if key == "differ" and out_dir:
                with open(os.path.join(out_dir, f"{fmt}-{i}-{k}"), "wb") as f:
                    f.write(m)
    total = collections.Counter()
    for c in counts.values():
        total.update(c)
    print(json.dumps({"mutants_per_file": n, "seed": seed, "by_format": {k: dict(v) for k, v in counts.items()},
                      "total": dict(total)}, sort_keys=True))


if __name__ == "__main__":
    main()
