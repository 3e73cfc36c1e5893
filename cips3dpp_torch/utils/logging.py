"""Text-file metric logging (a copy of cips3dpp_tpu/utils/logging.py,
which imports no framework).

Behavioural contract: tl2's textlogger (SURVEY.md §5) — grouped scalar dicts
appended to per-group text files so runs can be compared/plotted offline.
One file per metric group: `{name}.txt` with `step value` lines.
"""

from __future__ import annotations

import collections
import json
import os
import time


class MetricLogger:
    def __init__(self, outdir: str, flush_every: int = 50):
        self.outdir = os.path.abspath(outdir)
        os.makedirs(self.outdir, exist_ok=True)
        self._buf: dict = collections.defaultdict(list)
        self._count = 0
        self.flush_every = flush_every
        self._t0 = time.time()

    def log(self, step: int, metrics: dict):
        for k, v in metrics.items():
            self._buf[k].append((step, float(v)))
        self._count += 1
        if self._count % self.flush_every == 0:
            self.flush()

    def flush(self):
        for k, rows in self._buf.items():
            with open(os.path.join(self.outdir, f"{k}.txt"), "a") as f:
                for step, v in rows:
                    f.write(f"{step} {v}\n")
        self._buf.clear()

    def log_text(self, message: str, name: str = "events"):
        """Free-form event line (timestamped) appended to `{name}.log`."""
        with open(os.path.join(self.outdir, f"{name}.log"), "a") as f:
            f.write(f"[{time.time() - self._t0:10.1f}s] {message}\n")

    def log_jsonl(self, step: int, metrics: dict, name: str = "metrics"):
        rec = {"step": step, "time": time.time() - self._t0}
        rec.update({k: float(v) for k, v in metrics.items()})
        with open(os.path.join(self.outdir, f"{name}.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")

    def save_figures(self, outdir: str | None = None):
        """Loss-curve PNG per metric group (tl2 textlogger's
        summary_dict2txtfig figure dumps, SURVEY.md §5): one curve from each
        `{name}.txt` written so far. Matplotlib is optional — silently a
        no-op without it (zero-egress envs may strip it)."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return []
        self.flush()
        outdir = os.path.abspath(outdir or self.outdir)
        os.makedirs(outdir, exist_ok=True)
        written = []
        for fn in sorted(os.listdir(self.outdir)):
            if not fn.endswith(".txt"):
                continue
            rows = []
            with open(os.path.join(self.outdir, fn)) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) == 2:
                        rows.append((int(parts[0]), float(parts[1])))
            if not rows:
                continue
            steps, vals = zip(*rows)
            fig, ax = plt.subplots(figsize=(6, 3.2), dpi=110)
            ax.plot(steps, vals, lw=1.0)
            ax.set_xlabel("step")
            ax.set_title(fn[:-4])
            ax.grid(True, alpha=0.3)
            fig.tight_layout()
            path = os.path.join(outdir, fn[:-4] + ".png")
            fig.savefig(path)
            plt.close(fig)
            written.append(path)
        return written
