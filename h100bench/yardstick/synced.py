"""A network behind a synchronize and a clock mark on each side of its
call (a frozen copy of the port's smoke bench's wrap). Put in place of
``PerspectiveFields.model``, it splits one ``inference_batch`` call into
the host preprocess with the copy to the card (entry to the network's
call), the device forward (the call, synchronized on both sides) and the
postprocess with the copies back (return of the network to return of the
call)."""

from __future__ import annotations

import time

import torch


class SyncedModule:
    def __init__(self, inner, device):
        self.inner, self.marks = inner, []
        self._cuda = torch.device(device).type == "cuda"

    def _sync(self):
        if self._cuda:
            torch.cuda.synchronize()

    def __call__(self, *args, **kwargs):
        self._sync()
        self.marks.append(time.perf_counter())
        out = self.inner(*args, **kwargs)
        self._sync()
        self.marks.append(time.perf_counter())
        return out

    def split_ms(self, calls: list) -> dict:
        """Each call's preprocess, forward and postprocess, ms, from the
        calls' (start, end) clock readings and the marks of their network
        calls (one network call per call)."""
        m = self.marks
        return {
            "preprocess": [(m[2 * k] - ts) * 1e3 for k, (ts, _) in enumerate(calls)],
            "forward": [(m[2 * k + 1] - m[2 * k]) * 1e3 for k in range(len(calls))],
            "postprocess": [(te - m[2 * k + 1]) * 1e3 for k, (_, te) in enumerate(calls)],
        }

    def __getattr__(self, name):
        return getattr(self.inner, name)
