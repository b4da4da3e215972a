"""Fixture: sanctioned Ctx access — factory methods, not the constructor."""


def make(rt, execution, key):
    a = rt.ctx(key)
    b = execution.make_ctx(key=key)
    return a, b
