"""Write the arithmetic-coded and lossless JPEG fixtures of tests/torch_jpeg/
and their manifest (needs gcc, libjpeg-turbo's `jpeglib.h`, PIL, imageio and
the JAX package):

    python tests/make_torch_jpeg.py

PIL writes neither arithmetic-coded nor lossless JPEGs, so the files are
encoded by a one-off C helper built here with gcc against `jpeglib.h` and
the libjpeg-turbo that PIL bundles (its `libjpeg-*.so.62.*`, found from
`PIL.__file__` and linked with `-Wl,-rpath`): the library that decodes them
in the JAX package, which has the encoder's arithmetic coding and
`jpeg_enable_lossless` (declared by hand, as the header may predate it).  The
helper and its build stay in a temporary directory.

The files cover sequential arithmetic coding (SOF9: gray, YCbCr at 4:4:4,
4:2:2, 4:2:0 and 4:4:0, RGB, CMYK, YCCK, qualities 5 / 50 / 95, restart
intervals 1 and 3, DAC conditioning other than the default), progressive
arithmetic coding (SOF10: libjpeg's simple progression, successive
approximation down to the last bit, a script cut after the DC and first AC
scans, which libjpeg smooths), and lossless coding (SOF3: predictors 1-7,
point transforms 0 / 1 / 3, gray, RGB (also with its first component at
2x1 and 2x2 sampling), CMYK, restart intervals, one scan per component), at
37x29 and at 1x1, 17x70 and 255x3; four that libjpeg or PIL refuse (a
lossless restart interval that is no whole number of rows; 6-bit lossless
samples; lossless YCbCr and YCCK, which libjpeg-turbo does not convert);
and the two
textures chip_smoke.py phase 17b times: a 2048x2048 4:2:0 SOF10 texture and
a 1024x1024 lossless RGB image.  PIL reads an arithmetic-coded scan only if
its data lies in the 65536-byte block of the file PIL has handed libjpeg
when the scan begins (see io/jpeg.py `_arith_limit`), so the 2048x2048 file
has COM segments before the scans that would cross such a block, which move
each such scan to the start of the next block.  Every file's name is in
`gltf_scenes.JPEG_FIXTURES`.

manifest.json holds for each file [shape, dtype, sha256 of the array's
bytes] of the JAX package's decodes, as tests/make_torch_formats.py writes
its: the glTF texture decode (`gltf._load_image`) under "rgba" and
`envmap.load_hdr` under "load_hdr", null where it refuses the file.  No
decoded image is stored.  tests/test_torch_jpeg_arith_lossless.py holds the
port to the manifest and to the JAX package here; chip_smoke.py phase 17
holds it to the manifest on a machine without PIL.
"""

from __future__ import annotations

import base64
import glob
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)
import gltf_scenes  # noqa: E402
from make_torch_formats import entry  # noqa: E402

HELPER = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>

void jpeg_enable_lossless(j_compress_ptr cinfo, int predictor_selection_value, int point_transform);

/* helper IN.raw WIDTH HEIGHT CHANNELS OUT.jpg [key=value ...]: IN holds
   WIDTH x HEIGHT pixels of CHANNELS bytes (1 gray, 3 RGB, 4 CMYK).  Keys:
   quality, baseline, arith, progressive (libjpeg's simple script), psv and
   pt (lossless), precision, restart (in MCUs), restart_rows, space (the
   J_COLOR_SPACE to store), h0..h3 / v0..v3 (sampling factors), L0, U0, K0,
   L1, U1, K1 (DAC conditioning of tables 0 and 1), optimize, and
   scan=COMPONENTS/Ss/Se/Ah/Al, once per scan of a script (COMPONENTS: the
   component indices as digits). */
int main(int argc, char **argv) {
    int w = atoi(argv[2]), h = atoi(argv[3]), c = atoi(argv[4]);
    size_t n = (size_t)w * h * c;
    unsigned char *px = malloc(n);
    FILE *f = fopen(argv[1], "rb");
    if (!f || fread(px, 1, n, f) != n) return 2;
    fclose(f);
    struct jpeg_compress_struct ci;
    struct jpeg_error_mgr err;
    ci.err = jpeg_std_error(&err);
    jpeg_create_compress(&ci);
    FILE *out = fopen(argv[5], "wb");
    jpeg_stdio_dest(&ci, out);
    ci.image_width = w;
    ci.image_height = h;
    ci.input_components = c;
    ci.in_color_space = c == 1 ? JCS_GRAYSCALE : (c == 3 ? JCS_RGB : JCS_CMYK);
    jpeg_set_defaults(&ci);
    int quality = 75, baseline = 1, progressive = 0, psv = 0, pt = 0, space = -1, nscans = 0;
    int samp[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    static jpeg_scan_info scans[64];
    for (int i = 6; i < argc; i++) {
        char key[64], comps[8];
        int v, ss, se, ah, al;
        if (sscanf(argv[i], "scan=%7[0-9]/%d/%d/%d/%d", comps, &ss, &se, &ah, &al) == 5) {
            jpeg_scan_info *s = &scans[nscans++];
            s->comps_in_scan = (int)strlen(comps);
            for (int k = 0; k < s->comps_in_scan; k++) s->component_index[k] = comps[k] - '0';
            s->Ss = ss, s->Se = se, s->Ah = ah, s->Al = al;
            continue;
        }
        if (sscanf(argv[i], "%63[^=]=%d", key, &v) != 2) return 4;
        if (!strcmp(key, "quality")) quality = v;
        else if (!strcmp(key, "baseline")) baseline = v;
        else if (!strcmp(key, "arith")) ci.arith_code = v;
        else if (!strcmp(key, "progressive")) progressive = v;
        else if (!strcmp(key, "psv")) psv = v;
        else if (!strcmp(key, "pt")) pt = v;
        else if (!strcmp(key, "precision")) ci.data_precision = v;
        else if (!strcmp(key, "restart")) ci.restart_interval = v;
        else if (!strcmp(key, "restart_rows")) ci.restart_in_rows = v;
        else if (!strcmp(key, "space")) space = v;
        else if (!strcmp(key, "optimize")) ci.optimize_coding = v;
        else if (key[0] == 'h' || key[0] == 'v') samp[(key[1] - '0') * 2 + (key[0] == 'v')] = v;
        else if (key[0] == 'L') ci.arith_dc_L[key[1] - '0'] = v;
        else if (key[0] == 'U') ci.arith_dc_U[key[1] - '0'] = v;
        else if (key[0] == 'K') ci.arith_ac_K[key[1] - '0'] = v;
        else return 5;
    }
    if (space >= 0) {
        UINT8 L[NUM_ARITH_TBLS], U[NUM_ARITH_TBLS], K[NUM_ARITH_TBLS];
        memcpy(L, ci.arith_dc_L, sizeof(L));
        memcpy(U, ci.arith_dc_U, sizeof(U));
        memcpy(K, ci.arith_ac_K, sizeof(K));
        jpeg_set_colorspace(&ci, (J_COLOR_SPACE)space);
        memcpy(ci.arith_dc_L, L, sizeof(L));
        memcpy(ci.arith_dc_U, U, sizeof(U));
        memcpy(ci.arith_ac_K, K, sizeof(K));
    }
    jpeg_set_quality(&ci, quality, baseline);
    for (int k = 0; k < ci.num_components && k < 4; k++) {
        if (samp[2 * k]) ci.comp_info[k].h_samp_factor = samp[2 * k];
        if (samp[2 * k + 1]) ci.comp_info[k].v_samp_factor = samp[2 * k + 1];
    }
    if (progressive) jpeg_simple_progression(&ci);
    if (psv) jpeg_enable_lossless(&ci, psv, pt);
    if (nscans) {
        ci.scan_info = scans;
        ci.num_scans = nscans;
    }
    jpeg_start_compress(&ci, TRUE);
    while (ci.next_scanline < ci.image_height) {
        JSAMPROW row = px + (size_t)ci.next_scanline * w * c;
        jpeg_write_scanlines(&ci, &row, 1);
    }
    jpeg_finish_compress(&ci);
    fclose(out);
    jpeg_destroy_compress(&ci);
    return 0;
}
"""

JCS_GRAYSCALE, JCS_RGB, JCS_YCbCr, JCS_CMYK, JCS_YCCK = 1, 2, 3, 4, 5
SIZES = {"37x29": (37, 29), "1x1": (1, 1), "17x70": (17, 70), "255x3": (255, 3)}  # width x height
ARITH = dict(arith=1)
SAMPLING = {"444": dict(h0=1, v0=1), "422": dict(h0=2, v0=1), "420": dict(h0=2, v0=2), "440": dict(h0=1, v0=2)}
LOSSLESS_SAMPLING = {"11": dict(h0=1, v0=1), "21": dict(h0=2, v0=1), "22": dict(h0=2, v0=2)}
# Successive approximation to the last bit of every band (libjpeg's simple
# script stops one bit short of it for DC and at 1 for AC).
SA_SCRIPT = ("scan=012/0/0/0/2", "scan=012/0/0/2/1", "scan=0/1/5/0/3", "scan=0/6/63/0/3", "scan=1/1/63/0/1",
             "scan=2/1/63/0/1", "scan=0/1/63/3/2", "scan=0/1/63/2/1", "scan=0/1/63/1/0", "scan=012/0/0/1/0",
             "scan=1/1/63/1/0", "scan=2/1/63/1/0")
# DC and the first AC scans only: the first 9 AC coefficients of the chroma
# stay incomplete, so libjpeg block-smooths the file.
CUT_SCRIPT = ("scan=012/0/0/0/1", "scan=0/1/5/0/2", "scan=0/6/63/0/2", "scan=2/1/2/0/1", "scan=1/1/63/0/1")
CUT_GRAY = ("scan=0/0/0/0/0", "scan=0/1/2/0/0")
PER_COMPONENT = ("scan=0/0/0/0/0", "scan=1/0/0/0/0", "scan=2/0/0/0/0")  # lossless: Ss is the predictor, set below

FIXTURES = {
    # SOF9, sequential arithmetic coding.
    "arith-gray-q50-37x29.jpg": (1, "37x29", dict(ARITH, quality=50)),
    **{f"arith-ycc{s}-q50-37x29.jpg": (3, "37x29", dict(ARITH, quality=50, **f)) for s, f in SAMPLING.items()},
    "arith-rgb-adobe0-q75-37x29.jpg": (3, "37x29", dict(ARITH, quality=75, space=JCS_RGB)),
    "arith-cmyk-q75-37x29.jpg": (4, "37x29", dict(ARITH, quality=75)),
    "arith-ycck-q75-37x29.jpg": (4, "37x29", dict(ARITH, quality=75, space=JCS_YCCK, h0=2, v0=2)),
    "arith-ycc420-q5-16bit-tables-37x29.jpg": (3, "37x29", dict(ARITH, quality=5, baseline=0, h0=2, v0=2)),
    "arith-ycc420-q95-37x29.jpg": (3, "37x29", dict(ARITH, quality=95, h0=2, v0=2)),
    "arith-ycc420-rst1-37x29.jpg": (3, "37x29", dict(ARITH, quality=60, restart=1)),
    "arith-ycc444-rst3-37x29.jpg": (3, "37x29", dict(ARITH, quality=60, restart=3, h0=1, v0=1)),
    "arith-gray-rst3-17x70.jpg": (1, "17x70", dict(ARITH, quality=70, restart=3)),
    "arith-dac-L2-U6-K2-ycc420-37x29.jpg": (3, "37x29", dict(ARITH, quality=80, L0=2, U0=6, K0=2, L1=1, U1=3,
                                                             K1=30)),
    "arith-dac-L0-U0-K63-gray-37x29.jpg": (1, "37x29", dict(ARITH, quality=90, L0=0, U0=0, K0=63)),
    "arith-ycc420-1x1.jpg": (3, "1x1", dict(ARITH, quality=50)),
    "arith-ycc422-17x70.jpg": (3, "17x70", dict(ARITH, quality=50, h0=2, v0=1)),
    "arith-ycc420-rst3-255x3.jpg": (3, "255x3", dict(ARITH, quality=50, restart=3)),
    # SOF10, progressive arithmetic coding.
    "arith-prog-ycc420-37x29.jpg": (3, "37x29", dict(ARITH, quality=75, progressive=1)),
    "arith-prog-gray-37x29.jpg": (1, "37x29", dict(ARITH, quality=75, progressive=1)),
    "arith-prog-ycc444-q95-37x29.jpg": (3, "37x29", dict(ARITH, quality=95, progressive=1, h0=1, v0=1)),
    "arith-prog-cmyk-37x29.jpg": (4, "37x29", dict(ARITH, quality=75, progressive=1)),
    "arith-prog-rst2-ycc422-37x29.jpg": (3, "37x29", dict(ARITH, quality=75, progressive=1, restart=2, h0=2, v0=1)),
    "arith-prog-sa-to-bit-0-ycc444-37x29.jpg": (3, "37x29", dict(ARITH, quality=85, h0=1, v0=1)),
    "arith-prog-smoothed-ycc420-37x29.jpg": (3, "37x29", dict(ARITH, quality=70)),
    "arith-prog-smoothed-gray-17x70.jpg": (1, "17x70", dict(ARITH, quality=70)),
    "arith-prog-ycc420-1x1.jpg": (3, "1x1", dict(ARITH, quality=75, progressive=1)),
    "arith-prog-ycc420-255x3.jpg": (3, "255x3", dict(ARITH, quality=75, progressive=1)),
    # SOF3, lossless.
    **{f"lossless-gray-p{p}-37x29.jpg": (1, "37x29", dict(psv=p)) for p in range(1, 8)},
    "lossless-rgb-p1-pt0-37x29.jpg": (3, "37x29", dict(psv=1, space=JCS_RGB)),
    "lossless-rgb-p4-pt1-37x29.jpg": (3, "37x29", dict(psv=4, pt=1, space=JCS_RGB)),
    "lossless-rgb-p7-pt3-37x29.jpg": (3, "37x29", dict(psv=7, pt=3, space=JCS_RGB)),
    **{f"lossless-rgb-sampling-{s}-p6-37x29.jpg": (3, "37x29", dict(psv=6, **f)) for s, f in LOSSLESS_SAMPLING.items()},
    "lossless-cmyk-p5-37x29.jpg": (4, "37x29", dict(psv=5)),
    "lossless-rgb-p2-rst-rows-2-37x29.jpg": (3, "37x29", dict(psv=2, space=JCS_RGB, restart_rows=2)),
    "lossless-rgb-sampling-22-p4-rst-rows-1-37x29.jpg": (3, "37x29", dict(psv=4, restart_rows=1, h0=2, v0=2)),
    "lossless-rgb-p3-per-component-scans-37x29.jpg": (3, "37x29", dict(psv=3, space=JCS_RGB)),
    "lossless-gray-p7-1x1.jpg": (1, "1x1", dict(psv=7)),
    "lossless-rgb-sampling-21-p5-17x70.jpg": (3, "17x70", dict(psv=5, h0=2, v0=1)),
    "lossless-gray-p4-pt1-rst-rows-1-255x3.jpg": (1, "255x3", dict(psv=4, pt=1, restart_rows=1)),
    # Refused by libjpeg or PIL: a restart interval that is no whole number
    # of rows of MCUs (the DRI rewritten to 5); 6-bit samples; YCbCr and YCCK
    # (the Adobe transform rewritten to 1 and 2: libjpeg-turbo's encoder
    # writes a lossless file in the colour space it is given, and its decoder
    # converts none).
    "lossless-rgb-restart-5-mcus-refused-37x29.jpg": (3, "37x29", dict(psv=1, space=JCS_RGB, restart_rows=1,
                                                                       dri=5)),
    "lossless-gray-6-bit-refused-37x29.jpg": (1, "37x29", dict(psv=1, precision=6)),
    "lossless-ycc-adobe-1-refused-37x29.jpg": (3, "37x29", dict(psv=1, adobe=1)),
    "lossless-ycck-adobe-2-refused-37x29.jpg": (4, "37x29", dict(psv=1, adobe=2)),
}
SCRIPTS = {"arith-prog-sa-to-bit-0-ycc444-37x29.jpg": SA_SCRIPT,
           "arith-prog-smoothed-ycc420-37x29.jpg": CUT_SCRIPT, "arith-prog-smoothed-gray-17x70.jpg": CUT_GRAY,
           "lossless-rgb-p3-per-component-scans-37x29.jpg": tuple(s.replace("/0/0/0/0", "/3/0/0/0")
                                                                  for s in PER_COMPONENT)}
TIMING = {
    gltf_scenes.JPEG_TIMING[0]: (3, dict(ARITH, quality=75, progressive=1)),
    gltf_scenes.JPEG_TIMING[1]: (3, dict(psv=1, space=JCS_RGB, optimize=1)),
}


def photo(seed: int, w: int, h: int, channels: int) -> np.ndarray:
    """(h, w, channels) uint8: smooth colour fields, a dark disc and noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w] / max(h, w, 2)
    fields = [np.sin(9 * x + 3 * y), np.cos(7 * x * y + 2), np.sin(20 * (x - y) ** 2), np.cos(5 * x - 4 * y)]
    img = np.stack(fields[: max(channels, 1)], axis=-1) * 110 + 128
    img[(x - 0.5) ** 2 + (y - 0.4) ** 2 < 0.05] *= 0.4
    img = np.clip(img + rng.normal(0.0, 12.0, img.shape), 0, 255).astype(np.uint8)
    return img[..., :channels]


def marble(n: int) -> np.ndarray:
    """(n, n, 3) uint8: a veined marble texture (sine veins bent by a few
    octaves of smooth noise), the 2048x2048 arithmetic-coded timing file."""
    rng = np.random.default_rng(19)
    y, x = np.mgrid[0:n, 0:n].astype(np.float32) / n
    turb = np.zeros((n, n), np.float32)
    for octave in range(5):
        f = 2 ** (octave + 1)
        coarse = rng.uniform(-1, 1, (f + 1, f + 1)).astype(np.float32)
        i, j = y * f, x * f
        i0, j0 = np.minimum(i.astype(int), f - 1), np.minimum(j.astype(int), f - 1)
        ti, tj = i - i0, j - j0
        ti, tj = ti * ti * (3 - 2 * ti), tj * tj * (3 - 2 * tj)
        turb += (coarse[i0, j0] * (1 - ti) * (1 - tj) + coarse[i0 + 1, j0] * ti * (1 - tj)
                 + coarse[i0, j0 + 1] * (1 - ti) * tj + coarse[i0 + 1, j0 + 1] * ti * tj) / f
    vein = 0.5 + 0.5 * np.sin(40 * (x + 0.6 * y) + 14 * turb)
    base = np.array([232, 226, 214], np.float32)
    dark = np.array([96, 104, 118], np.float32)
    rgb = base + (dark - base) * (vein ** 6)[..., None]
    return np.clip(rgb, 0, 255).astype(np.uint8)


def gradient(n: int) -> np.ndarray:
    """(n, n, 3) uint8: a smooth procedural image (slow colour waves), the
    1024x1024 lossless timing file."""
    y, x = np.mgrid[0:n, 0:n].astype(np.float32) / n
    rgb = np.stack([128 + 100 * np.sin(2.1 * x + 1.3 * y), 128 + 90 * np.cos(1.7 * x * y + 0.4 + 2 * y),
                    128 + 80 * np.sin(3.3 * (x - y) + 1)], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def pil_libjpeg() -> str:
    import PIL

    found = glob.glob(os.path.join(os.path.dirname(PIL.__file__), os.pardir, "pillow.libs", "libjpeg-*.so.62*"))
    if not found:
        raise RuntimeError("PIL's bundled libjpeg-turbo (pillow.libs/libjpeg-*.so.62.*) is not there")
    return os.path.realpath(found[0])


def build_helper(tmp: str) -> str:
    src, helper = os.path.join(tmp, "helper.c"), os.path.join(tmp, "helper")
    with open(src, "w") as f:
        f.write(HELPER)
    lib = pil_libjpeg()
    subprocess.run(["gcc", "-O2", src, lib, f"-Wl,-rpath,{os.path.dirname(lib)}", "-o", helper], check=True)
    return helper


def encode(helper: str, tmp: str, img: np.ndarray, settings: dict, script=()) -> bytes:
    raw, out = os.path.join(tmp, "in.raw"), os.path.join(tmp, "out.jpg")
    img = img if img.ndim == 3 else img[..., None]
    np.ascontiguousarray(img).tofile(raw)
    args = [f"{k}={v}" for k, v in settings.items() if k not in ("dri", "adobe")] + list(script)
    subprocess.run([helper, raw, str(img.shape[1]), str(img.shape[0]), str(img.shape[2]), out, *args], check=True)
    with open(out, "rb") as f:
        data = f.read()
    if "dri" in settings:  # the encoder refuses such an interval; the DRI segment is rewritten after it
        at = data.index(b"\xff\xdd\x00\x04") + 4
        data = data[:at] + settings["dri"].to_bytes(2, "big") + data[at + 2 :]
    if "adobe" in settings:  # the Adobe APP14 segment's transform byte
        at = data.index(b"Adobe") + 11
        data = data[:at] + bytes([settings["adobe"]]) + data[at + 1 :]
    return data


def scans(data: bytes) -> list:
    """(offset of the segment group that leads to each SOS, the offset of
    the scan's data, the offset of the marker after it) of a JPEG's scans;
    the group starts at the DAC / DHT segments right before the SOS."""
    out, pos, lead = [], 2, 2
    while pos + 4 <= len(data):
        marker = data[pos + 1]
        if marker == 0xD9:
            break
        length = (data[pos + 2] << 8) | data[pos + 3]
        nxt = pos + 2 + length
        if marker == 0xDA:
            end = nxt
            while not (data[end] == 0xFF and data[end + 1] not in (0, 0xFF) and not 0xD0 <= data[end + 1] <= 0xD7):
                end += 1
            out.append((lead, nxt, end))
            nxt = lead = end
        elif marker not in (0xCC, 0xC4):
            lead = nxt
        pos = nxt
    return out


def fit_pil_blocks(data: bytes, block: int = 65536) -> bytes:
    """Put a COM segment before each arithmetic-coded scan whose data would
    cross the 65536-byte block PIL has handed libjpeg when the scan begins,
    so that the scan's header ends 1 byte into the next block."""
    out, at = bytearray(), 0
    for lead, start, end in scans(data):
        shift = len(out) - at  # where this scan's bytes land in the output
        frontier = block * max(1, -(-(start + shift) // block))
        if end + shift + 2 > frontier:
            pad = (frontier + 1 - (start + shift)) % block
            if pad < 4:
                pad += block
            if end - start + 2 > block - 1:
                raise ValueError(f"a scan of {end - start} bytes cannot fit in a block of {block}")
            out += data[at:lead] + b"\xff\xfe" + (pad - 2).to_bytes(2, "big") + bytes(pad - 4)
            at = lead
    out += data[at:]
    return bytes(out)


def main() -> None:
    from vpt_tpu.scene import envmap, gltf

    assert sorted(gltf_scenes.JPEG_FIXTURES) == sorted([*FIXTURES, *TIMING])
    os.makedirs(gltf_scenes.JPEG_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        helper = build_helper(tmp)
        for i, (name, (channels, size, settings)) in enumerate(FIXTURES.items()):
            img = photo(100 + i, *SIZES[size], channels)
            if "6-bit" in name:
                img = img >> 2
            data = encode(helper, tmp, img, settings, SCRIPTS.get(name, ()))
            with open(os.path.join(gltf_scenes.JPEG_DIR, name), "wb") as f:
                f.write(data)
        for name, (channels, settings) in TIMING.items():
            if "arith" in name:
                data = fit_pil_blocks(encode(helper, tmp, marble(2048), settings))
            else:
                data = encode(helper, tmp, gradient(1024), settings)
            with open(os.path.join(gltf_scenes.JPEG_DIR, name), "wb") as f:
                f.write(data)
    manifest = {}
    for name in gltf_scenes.JPEG_FIXTURES:
        path = os.path.join(gltf_scenes.JPEG_DIR, name)
        with open(path, "rb") as f:
            data = f.read()
        doc = {"images": [{"uri": "data:image/jpeg;base64," + base64.b64encode(data).decode()}]}
        manifest[name] = {"rgba": entry(lambda: gltf._load_image(doc, [], HERE, 0)),
                          "load_hdr": entry(lambda: envmap.load_hdr(path))}
    with open(os.path.join(gltf_scenes.JPEG_DIR, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    size = sum(os.path.getsize(os.path.join(gltf_scenes.JPEG_DIR, n)) for n in os.listdir(gltf_scenes.JPEG_DIR))
    refused = sorted(n for n, e in manifest.items() if e["rgba"] is None)
    print(f"{len(manifest)} fixtures and their manifest in {gltf_scenes.JPEG_DIR}: {size} bytes; the JAX package "
          f"refuses {refused}")


if __name__ == "__main__":
    main()
