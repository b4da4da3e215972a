"""The vocabulary-parallel head's pieces in one process, no process group:
``launch.mesh.chunk_bounds``' chunks, ``models.lm.vocab_chunk_terms`` over
emulated vocabulary chunks against ``torch.logsumexp`` over the whole
vocabulary, and the layout rules of ``models.lm._vocab_rows`` on layout
meshes (the cases that keep another path move nothing, so they need no
group; the all-to-all and the gathers run in the gloo rank groups of
``test_torch_distributed_families.py``)."""
import numpy as np
import pytest
import torch

V = 254
ROWS, SEQ, D = 3, 5, 16


def _mesh(shape, rank=0):
    from repro_torch.launch.mesh import Mesh

    return Mesh(shape, ("data", "model"), rank=rank)


@pytest.mark.parametrize("size,n", [(256, 4), (254, 4), (254, 2), (256_206, 16),
                                    (262_144, 16), (7, 3), (5, 5), (9, 1)])
def test_chunk_bounds_cover_the_whole_in_order(size, n):
    """The chunks are contiguous, cover ``[0, size)`` in rank order, each
    ``ceil(size / n)`` long but the last, which is shorter where ``n`` does
    not divide ``size`` (seamless: 15 chunks of 16,013 and one of 16,011)."""
    from repro_torch.launch.mesh import chunk_bounds

    c = -(-size // n)
    at = 0
    for i in range(n):
        lo, m = chunk_bounds(size, n, i)
        assert lo == at
        assert m == (c if i < n - 1 else size - (n - 1) * c)
        at += m
    assert at == size
    if (size, n) == (256_206, 16):
        assert chunk_bounds(size, n, 0)[1] == 16_013 and chunk_bounds(size, n, 15)[1] == 16_011


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 16])
def test_chunk_terms_sum_to_the_whole_vocabulary_nll(n):
    """``vocab_chunk_terms`` of ``n`` emulated ranks' chunks, summed as the
    ranks sum them, against ``logsumexp`` over the whole vocabulary minus
    the label's logit, and the gradient of its sum through the chunks
    against ``softmax - onehot``: within 1e-6."""
    from repro_torch.launch.mesh import chunk_bounds
    from repro_torch.models.lm import vocab_chunk_terms

    rs = np.random.RandomState(n)
    logits = torch.as_tensor((rs.standard_normal((ROWS, SEQ, V)) * 3).astype(np.float32))
    labels = torch.as_tensor(rs.randint(0, V, (ROWS, SEQ)))
    lg = logits.clone().requires_grad_(True)
    chunks = [lg.narrow(-1, *chunk_bounds(V, n, i)) for i in range(n)]
    m = torch.stack([c.detach().amax(-1) for c in chunks]).amax(0)
    terms = [vocab_chunk_terms(c, labels, chunk_bounds(V, n, i)[0], m)
             for i, c in enumerate(chunks)]
    se = sum(t[0] for t in terms)
    t = sum(t[1] for t in terms)
    nll = torch.log(se) + m - t
    want = torch.logsumexp(logits, -1) - logits.gather(-1, labels[..., None])[..., 0]
    np.testing.assert_allclose(nll.detach().numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    (g,) = torch.autograd.grad(nll.sum(), lg)
    want_g = torch.softmax(logits, -1) - torch.nn.functional.one_hot(labels, V)
    np.testing.assert_allclose(g.numpy(), want_g.numpy(), rtol=1e-6, atol=1e-6)


def _ctx(mesh):
    from repro_torch.nn.common import Ctx

    return Ctx(mesh=mesh)


def test_vocab_rows_keeps_the_other_paths_by_rule():
    """``_vocab_rows`` returns None (the head keeps the path ``_mesh_head``
    gives it otherwise) where the weight's vocabulary is already split over
    model (the column-parallel untied head), where a d-split table's
    vocabulary does not divide the model axis (no equal all-to-all chunks:
    the row-parallel path), and where the last chunk would be empty."""
    from repro_torch.launch.sharding import set_spec
    from repro_torch.models.lm import _vocab_rows

    mesh = _mesh((1, 4))
    column = set_spec(torch.zeros(V + 2, D), ("model", None), mesh)
    assert _vocab_rows(column, _ctx(mesh), tied=False) is None
    table = set_spec(torch.zeros(V, D // 4), (None, "model"), mesh)
    assert _vocab_rows(table, _ctx(mesh), tied=True) is None
    assert _vocab_rows(torch.zeros(3, D), _ctx(mesh), tied=False) is None


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_emulated_ranks_of_a_replicated_head_make_the_whole_head(shape, tied):
    """A head weight whole over model (an untied vocabulary of 254 on 4 or
    2 model ranks, or a tied table whose d the rules left whole): each
    emulated rank's ``_vocab_rows`` are its ``chunk_bounds`` rows, no row
    padded, its ``VocabSplit`` starts there, and the ranks' chunk logits
    through ``vocab_chunk_terms`` give the whole head's nll within 1e-6."""
    from repro_torch.launch.mesh import chunk_bounds
    from repro_torch.models.lm import _vocab_rows, vocab_chunk_terms

    rs = np.random.RandomState(11)
    w = torch.as_tensor((rs.standard_normal((V, D)) / 4).astype(np.float32))
    x = torch.as_tensor(rs.standard_normal((ROWS, SEQ, D)).astype(np.float32))
    labels = torch.as_tensor(rs.randint(0, V, (ROWS, SEQ)))
    n = shape[1]
    parts = []
    for r in range(n):  # the model ranks of data rank 0
        mesh = _mesh(shape, rank=r)
        w_v, split = _vocab_rows(w, _ctx(mesh), tied=tied)
        lo, m = chunk_bounds(V, n, r)
        assert split.size == V and split.start(mesh) == lo
        assert torch.equal(w_v, w[lo:lo + m])
        parts.append((lo, torch.matmul(x, w_v.t())))
    mx = torch.stack([p.amax(-1) for _, p in parts]).amax(0)
    terms = [vocab_chunk_terms(p, labels, lo, mx) for lo, p in parts]
    nll = torch.log(sum(t[0] for t in terms)) + mx - sum(t[1] for t in terms)
    logits = torch.matmul(x, w.t())
    want = torch.logsumexp(logits, -1) - logits.gather(-1, labels[..., None])[..., 0]
    np.testing.assert_allclose(nll.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
