"""Interactive terminal viewer: progressive path tracing + fly camera
(port of vpt_tpu/viewer.py).

Each tick applies pending keystrokes to the FlyCamera (a move resets the
accumulation) and runs one progressive dispatch, then redraws the
tonemapped image in place with ANSI truecolor half-blocks (2 pixels per
character cell).

Keys: w/a/s/d move, q/e down/up, i/j/k/l look, +/- speed, o save PNG,
x quit.  Run via `python -m vpt_tpu_torch view cornell --size 128`.

The frame/step logic is TTY-free (`TerminalViewer.step`) so tests can
drive it headless; `run()` adds raw-mode stdin and the redraw loop.
"""

from __future__ import annotations

import sys
import time
from typing import Optional

import numpy as np

ESC = "\x1b"
_LOOK_STEP = 6.0  # degrees per keypress


class TerminalViewer:
    """Progressive renderer + FlyCamera bound to terminal I/O."""

    def __init__(self, renderer, cols: int = 100, move_speed: Optional[float] = None):
        self.r = renderer
        self.cols = cols
        if move_speed is None:
            # Default speed: the scene's extent / 20.
            ext = self._scene_extent()
            move_speed = float(ext) / 20.0 if ext > 0 else 0.5
        self.move_speed = move_speed
        self.frames_drawn = 0
        self.last_keys = ""

    def _scene_extent(self) -> float:
        cl = self.r.scene_data.clusters  # device tensors: read through the host
        lo = cl.group_min.cpu().numpy().min(axis=0)
        hi = cl.group_max.cpu().numpy().max(axis=0)
        return float(np.max(hi - lo))

    # ------------------------------------------------------------- input

    def apply_keys(self, keys: str) -> bool:
        """Apply movement/look keys to the fly camera.  Returns True if the
        camera changed (accumulation must restart)."""
        cam = self.r.camera
        moved = False
        for k in keys:
            if k == "w":
                cam.move("forward", self.move_speed)
            elif k == "s":
                cam.move("back", self.move_speed)
            elif k == "a":
                cam.move("left", self.move_speed)
            elif k == "d":
                cam.move("right", self.move_speed)
            elif k == "e":
                cam.move("up", self.move_speed)
            elif k == "q":
                cam.move("down", self.move_speed)
            elif k == "j":
                cam.rotate(-_LOOK_STEP, 0.0)
            elif k == "l":
                cam.rotate(_LOOK_STEP, 0.0)
            elif k == "i":
                cam.rotate(0.0, _LOOK_STEP)
            elif k == "k":
                cam.rotate(0.0, -_LOOK_STEP)
            elif k == "+":
                self.move_speed *= 1.5
                continue
            elif k == "-":
                self.move_speed /= 1.5
                continue
            else:
                continue
            moved = True
        if moved:
            self.r.sync_fly_camera()  # resets the accumulation
        return moved

    # ------------------------------------------------------------- frame

    def step(self, keys: str = "") -> str:
        """One viewer tick: apply keys, run one progressive dispatch (unless
        the sample budget is already met), return the ANSI frame string."""
        self.apply_keys(keys)
        if self.r.samples_accumulated < self.r.max_samples:
            self.r.path_trace()
        img = self.r.output_image()  # (H, W, 3) float in [0,1]
        self.frames_drawn += 1
        return self.ansi_frame(img)

    def ansi_frame(self, img: np.ndarray) -> str:
        """Render an (H, W, 3) [0,1] image as truecolor half-block rows."""
        h, w = img.shape[:2]
        cols = min(self.cols, w)
        # Nearest-neighbour resample to (2*rows_avail, cols)
        rows = max(2, (h * cols // max(w, 1)) // 2 * 2)
        yi = (np.arange(rows) * (h / rows)).astype(np.int32)
        xi = (np.arange(cols) * (w / cols)).astype(np.int32)
        small = (np.clip(img[yi][:, xi], 0.0, 1.0) * 255.0 + 0.5).astype(np.int32)
        out = []
        for y in range(0, rows - 1, 2):
            top, bot = small[y], small[y + 1]
            line = []
            for x in range(cols):
                tr, tg, tb = top[x]
                br, bg, bb = bot[x]
                line.append(
                    f"{ESC}[38;2;{tr};{tg};{tb}m{ESC}[48;2;{br};{bg};{bb}m▀"
                )
            out.append("".join(line) + f"{ESC}[0m")
        r = self.r
        rate = r.segments_traced / max(r.render_seconds, 1e-9) / 1e6
        cam = r.camera
        out.append(
            f"{ESC}[0m{r.samples_accumulated}/{r.max_samples} spp  "
            f"{rate:.2f} M segs/s  pos=({cam.position[0]:.2f},"
            f"{cam.position[1]:.2f},{cam.position[2]:.2f}) "
            f"yaw={cam.yaw:.0f} pitch={cam.pitch:.0f} speed={self.move_speed:.2f}  "
            f"[wasdqe move, ijkl look, o save, x quit]"
        )
        return "\n".join(out)

    # --------------------------------------------------------------- run

    def run(self) -> None:
        """Raw-mode interactive loop (requires a TTY)."""
        if not sys.stdin.isatty():
            raise RuntimeError("interactive viewer needs a TTY; use step() headless")
        import select
        import termios
        import tty

        fd = sys.stdin.fileno()
        old = termios.tcgetattr(fd)
        sys.stdout.write(f"{ESC}[2J")  # clear once
        try:
            tty.setcbreak(fd)
            while True:
                keys = ""
                while select.select([sys.stdin], [], [], 0)[0]:
                    keys += sys.stdin.read(1)
                if "x" in keys:
                    break
                if "o" in keys:
                    self.r.save("viewer_frame.png", embed_stats=True)
                    keys = keys.replace("o", "")
                frame = self.step(keys)
                sys.stdout.write(f"{ESC}[H" + frame + "\n")
                sys.stdout.flush()
                if (
                    self.r.samples_accumulated >= self.r.max_samples
                    and not keys
                ):
                    time.sleep(0.05)  # budget met: idle until input
        finally:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)
            sys.stdout.write(f"{ESC}[0m\n")
