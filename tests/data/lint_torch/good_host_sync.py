"""Fixture: static metadata, host-annotated arguments and numpy values inside
step roots, and host reads outside them — no finding."""
import numpy as np


def make_train_step(opt):
    def step(state, batch, key: int, scale: float):
        width = float(state.shape[0])
        n = int(len(batch))
        rows = np.zeros(4)
        first = int(rows[0])
        return state * width * float(scale), n, int(key), first

    return step


def outside(x):
    return float(x.sum()), x.cpu().numpy(), x.item()


class Engine:
    def _prefill_wave(self, wave: list, align: int):
        off = 0
        for r in wave:
            off += len(r) * align
        return int(off), int(self.serve.bucket_for(off))
