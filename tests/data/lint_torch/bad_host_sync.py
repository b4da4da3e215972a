"""Fixture: host reads inside step roots (host-sync-in-step)."""
import torch


def make_train_step(opt, width):
    n = int(width)  # the factory's own body runs once: not a step root

    def step(state, batch, key: int):
        loss = (state * batch).sum() * n
        scale = float(loss)
        host = loss.cpu().numpy()
        seed = int(key)
        return scale, host, loss.item(), batch.tolist(), seed

    return step


class Engine:
    def _decode_one_step(self, logits):
        best = torch.argmax(logits)
        return bool(best > 0)
