"""The harness's readings frozen from the commit before architectures were
plug-ins (ec95ad8), so that moving Llama, Mistral and Mixtral into
``archs/`` and ``build/`` moved no number the harness reads:

- at tiny sizes (each architecture's ``tiny``; Mixtral also at 4 experts,
  where routing chooses), seeds 3 and ``2**31 + 5``: the drawn fields and
  dense leaves of layers 0 and 1 and the dense leaves outside the layers
  (names, order and bits), the packed tree the port receives, the
  reference's float32 logits and the fp8 control's of two fixed id
  sequences, and for a routed model each position's smallest router
  margin;
- at the published sizes: ``_arith``'s counts.

Digests are sha256 of each tensor's dtype, shape and bytes, taken on the
CPU with one thread."""
import dataclasses
import hashlib
import json
import os

import pytest
import torch

from portbench import archs, inputs, program
from portbench.metrics import _arith
from portbench.record import Step
from portbench.reference.model import Reference

from conftest import REPO

FIELDS = {
    "mistral7b/3": "6d1092a95d77995019bd062d",
    "mistral7b/2147483653": "dba1241f06dc3ce09563ca4f",
    "mixtral8x7b/3": "999fbb5895d3a6ead651e8a5",
    "mixtral8x7b/2147483653": "d081b3391932860f17b66dd9",
    "mixtral8x7b@4/3": "f707d8d8507312178dbb4592",
    "mixtral8x7b@4/2147483653": "5553fe2e0604727217aaca44",
}

PACKED = {
    "mistral7b/3": "e1052cb5f9583a6d29f79658",
    "mistral7b/2147483653": "589bc5b21f065ed15e56c406",
    "mixtral8x7b/3": "2e61175b7ba4ca16ae5eafbf",
    "mixtral8x7b/2147483653": "10f41fdfa4a5aa268965333c",
    "mixtral8x7b@4/3": "c8fa90bf068faa06c73f53e2",
    "mixtral8x7b@4/2147483653": "b607daaaa3d0e75352b0e98c",
}

LOGITS = {
    "mistral7b/3": ("aa6f1e5b501a24e7ebf0f7cf", "0eb58041573e35c25896ab2b"),
    "mistral7b/2147483653": ("f0f8484eeaaa6f880bc7f00b", "5f34ee48c99afa62b0a8f82f"),
    "mixtral8x7b/3": ("e30c7ba5777266ee394b0267", "fb138d2e3956d40272d58410"),
    "mixtral8x7b/2147483653": ("151643672478a2ca24e5ef8b", "89805c187cbefafa765c971c"),
    "mixtral8x7b@4/3": ("546779864177e13212f408a5", "82371ebe5edab6cc1a65db2e"),
    "mixtral8x7b@4/2147483653": ("a3dd46c70f0ba8c2406e05eb", "e667ac5275c3b274395ed913"),
}

CONTROL = {
    "mistral7b/3": ("12fc5fcead1c5ebd90f9da8b", "4f93ebec250bb6712da7cad8"),
    "mistral7b/2147483653": ("f8e1ed3bbd21db99a13a1cfc", "ab2bc3e403c00cf8912b417d"),
    "mixtral8x7b/3": ("447f24875eeba0173998e347", "53de84a13f04daad244fe0e5"),
    "mixtral8x7b/2147483653": ("3bd09199099bd530f05de73b", "c016b481e2d7d2e90382bfdf"),
    "mixtral8x7b@4/3": ("28d636c7ebf3354bd5f5a563", "521f7691e25aefe2f060dc12"),
    "mixtral8x7b@4/2147483653": ("699dc8e9e98f3ec6d67e6a5c", "8a54b9473a21a7aa08e1c162"),
}

MARGINS = {
    "mixtral8x7b/3": ("ac0d42b40d81470b73e55c61", "c8d257426375b9f3cb5a8e91"),
    "mixtral8x7b/2147483653": ("ac0d42b40d81470b73e55c61", "c8d257426375b9f3cb5a8e91"),
    "mixtral8x7b@4/3": ("c801c99eeb0afdce98722914", "b5c8929192075cc301cc9740"),
    "mixtral8x7b@4/2147483653": ("e30587db3ebc1f528100b4e0", "d9968f56dae20ea361cec4a7"),
}

ARITH = {
    "mistral7b": {
        "token_flops": 14227079168.0,
        "attention_flops_1000": 524288000.0,
        "layer_linear_seconds": {1: 3.749246089552239e-05, 16: 3.8226072835820894e-05, 64: 4.057363104477612e-05, 512: 0.00022582234518907988, 2048: 0.0009032893807563195},
        "step_flops": 34572150505472.0,
        "step_linear_seconds": 0.03434231798276613},
    "mixtral8x7b": {
        "token_flops": 25497174016.0,
        "attention_flops_1000": 524288000.0,
        "layer_linear_seconds": {1: 6.773072238805971e-05, 16: 0.0002477691361191115, 64: 0.0002541231736810686, 512: 0.0004082173163033367, 2048: 0.0016328692652133468},
        "step_flops": 61068143493120.0,
        "step_linear_seconds": 0.06614233110834197},
}


def _config(name):
    with open(os.path.join(REPO, "portbench", "configs", name + ".json")) as f:
        return json.load(f)


def _tiny(key):
    name, _, at4 = key.partition("@")
    c = _config(name)
    c.update(archs.of(c).tiny(c, f32=bool(at4)))
    return c


def _dig(t):
    t = t.detach().contiguous().cpu()
    h = hashlib.sha256(f"{t.dtype}{tuple(t.shape)}".encode())
    h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:24]


def _agg(d):
    return hashlib.sha256(json.dumps(d).encode()).hexdigest()[:24]


def _tree(x, path=""):
    if isinstance(x, torch.Tensor):
        return {path: _dig(x)}
    out = {}
    if isinstance(x, dict):
        for k in x:
            out.update(_tree(x[k], f"{path}/{k}"))
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            out.update(_tree(v, f"{path}/{i}"))
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            out.update(_tree(getattr(x, f.name), f"{path}.{f.name}"))
    else:
        out[path] = repr(x)
    return out


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seqs():
    return [torch.as_tensor(inputs.synthetic_stream(512, 48, 7)),
            torch.as_tensor(inputs.synthetic_stream(512, 33, 8))]


@pytest.mark.parametrize("key", FIELDS)
def test_drawn_fields_and_packed_tree_are_frozen(key, one_thread):
    name, seed = key.rsplit("/", 1)
    c, seed = _tiny(name), int(seed)
    d = {}
    for li in (0, 1):
        fields, dense = inputs.draw_layer(c, seed, li, "cpu")
        for n, f in fields.items():
            for part in ("codes", "lut", "scales", "zeros"):
                d[f"{li}/{n}.{part}"] = _dig(getattr(f, part))
        for n, t in dense.items():
            d[f"{li}/{n}"] = _dig(t)
    for n, t in inputs.draw_dense(c, seed, "cpu").items():
        d[n] = _dig(t)
    assert _agg(d) == FIELDS[key]
    assert _agg(_tree(program.build_params(c, seed, "cpu"))) == PACKED[key]


@pytest.mark.parametrize("key", LOGITS)
def test_reference_logits_are_frozen(key, one_thread):
    name, seed = key.rsplit("/", 1)
    c, seed = _tiny(name), int(seed)
    ref = Reference(c, seed, "cpu")
    head = ref.head()
    assert tuple(_dig(h @ head.t()) for h in ref.hidden(_seqs())) == \
        LOGITS[key]
    margins = ref.min_margin
    assert (None if margins is None else tuple(map(_dig, margins))) == \
        MARGINS.get(key)
    cref = Reference(c, seed, "cpu", act="fp8")
    assert tuple(_dig(cref.logits(h, head))
                 for h in cref.hidden(_seqs())) == CONTROL[key]


@pytest.mark.parametrize("name", ARITH)
def test_arith_is_frozen(name):
    c, want = _config(name), ARITH[name]
    step = Step(0, 1, "admit", prefill=[300, 2048], decode_ctx=[5, 77, 1000])
    assert _arith.token_flops(c) == want["token_flops"]
    assert _arith.attention_flops(c, 1000) == want["attention_flops_1000"]
    for li in range(c["num_hidden_layers"]):
        assert {m: _arith.layer_linear_seconds(c, li, m)
                for m in want["layer_linear_seconds"]} == \
            want["layer_linear_seconds"]
    assert _arith.step_flops(c, step) == want["step_flops"]
    assert _arith.step_linear_seconds(c, step) == want["step_linear_seconds"]
