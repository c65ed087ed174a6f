"""Each zoo version's PersNet in the port against the tensor inventory of
the released checkpoints (perspectivefields_tpu/weights/MANIFEST.json):
the only check against the released files that needs no download. The
manifest is read with json alone; the models are built on the meta device,
so no weight memory is allocated."""

import json
import os

import pytest
import torch

from perspectivefields_tpu_torch.config import model_zoo
from perspectivefields_tpu_torch.models import PersNet

MANIFEST = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "perspectivefields_tpu", "weights", "MANIFEST.json",
)
# The low-level encoder's BatchNorm step counter: a training statistic the
# port's frozen BatchNorm does not keep (the reference loads with
# strict=False). It is taken out of the manifest's side; nothing else is.
BN_COUNTER = "ll_enc.bn1.num_batches_tracked"


@pytest.fixture(scope="module")
def manifest():
    with open(MANIFEST) as f:
        return json.load(f)


@pytest.mark.parametrize("version", list(model_zoo))
def test_state_dict_matches_the_released_inventory(manifest, version):
    entry = manifest[version]
    assert entry["tensor_count"] == len(entry["tensors"])
    want = {k: tuple(s) for k, s in entry["tensors"].items() if k != BN_COUNTER}
    assert len(want) == entry["tensor_count"] - 1
    with torch.device("meta"):
        net = PersNet(model_zoo[version]["config"])
    got = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert all(v.is_meta for v in net.state_dict().values())
    assert sorted(got.keys() - want.keys()) == []
    assert sorted(want.keys() - got.keys()) == []
    wrong = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
    assert not wrong, list(wrong.items())[:5]
    assert len(got) == (677 if version == "PersNet-360Cities" else 859)


def test_manifest_covers_the_zoo(manifest):
    assert set(manifest) == set(model_zoo)
