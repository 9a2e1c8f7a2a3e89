"""The CUDA-graph module's buffer helpers (``slam/graphs.py``), on the CPU:
``fill`` copies each tensor into its buffer unless it is that buffer's
memory already, also into a buffer that requires grad; ``shapes_key``
tells buffers apart by device, shape and dtype, never by value; ``clone``
gives a tree's leaves, in ``leaves``' order, new memory outside autograd.

Imports no jax. Runtime budget: well under 1 s.
"""

import torch

from dnsjax_torch.slam import graphs


def test_fill_key_and_clone(monkeypatch):
    copied = []
    real = torch._foreach_copy_
    monkeypatch.setattr(torch, "_foreach_copy_",
                        lambda dst, src: copied.append(len(dst)) or real(dst, src))
    buf, pose = torch.zeros(3), torch.zeros(4).requires_grad_(True)
    x, q = torch.arange(3.0), torch.arange(4.0)
    graphs.fill([buf, pose], [x, pose])
    assert torch.equal(buf, x) and copied == [1]
    graphs.fill([buf, pose], [buf, q])
    assert torch.equal(pose, q) and pose.requires_grad and copied == [1, 1]
    graphs.fill([buf, pose], [buf, pose])
    assert copied == [1, 1]  # nothing to copy: no launch

    key = graphs.shapes_key(torch.device("cpu"),
                            [torch.zeros(2, 3), torch.zeros(4, dtype=torch.int64)])
    assert key == ("cpu", ((2, 3), torch.float32), ((4,), torch.int64))
    assert graphs.shapes_key("cpu", [torch.ones(2, 3), torch.ones(4, dtype=torch.int64)]) == key
    assert graphs.shapes_key("cpu", [torch.zeros(3, 2), torch.zeros(4, dtype=torch.int64)]) != key
    assert graphs.shapes_key("cpu", [torch.zeros(2, 3), torch.zeros(4)]) != key

    tree = {"a": pose, "b": [x, {"c": buf}]}
    assert [t is u for t, u in zip(graphs.leaves(tree), [pose, x, buf])] == [True] * 3
    copy = graphs.clone(tree)
    for t, u in zip(graphs.leaves(copy), graphs.leaves(tree)):
        assert torch.equal(t, u) and t.data_ptr() != u.data_ptr() and not t.requires_grad
