"""Fixture: Python control flow on a step's tensors (tensor-branch)."""


def make_train_step(opt):
    def step(x, y):
        if x.sum() > 0:
            y = y + 1
        while y > 0:
            y = y - 1
        return y

    return step
