"""The port's data pipeline against the reference's: the sampler's index
stream (shuffled and not, across epochs, per process, after a resume),
SyntheticLMDataset, MixtureDataset and MemmapTokenDataset give exactly
the reference's examples; the DataLoader yields them as int64 tensors."""

import numpy as np
import pytest
import torch

from cloud_server_tpu.data import dataset as ref_ds
from cloud_server_tpu.data import loader as ref_loader
from cloud_server_tpu_torch.data import dataset, loader


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("process_index,process_count", [(0, 1), (1, 2)])
def test_sampler_index_stream_matches_reference(shuffle, process_index,
                                                process_count):
    kw = dict(seed=5, shuffle=shuffle, process_index=process_index,
              process_count=process_count)
    ref = ref_loader.ShardedSampler(23, 4, **kw)
    got = loader.ShardedSampler(23, 4, **kw)
    ir, ig = iter(ref), iter(got)
    for _ in range(17):  # past three epochs of 5 batches
        np.testing.assert_array_equal(next(ig), next(ir))
    assert got.state_dict() == ref.state_dict()
    state = {"epoch": 2, "batch_in_epoch": 3}
    ref.load_state_dict(state)
    got.load_state_dict(state)
    np.testing.assert_array_equal(next(iter(got)), next(iter(ref)))


def test_datasets_match_reference(tmp_path):
    syn_r = ref_ds.SyntheticLMDataset(9, 12, 50, seed=3)
    syn = dataset.SyntheticLMDataset(9, 12, 50, seed=3)
    assert len(syn) == len(syn_r)
    for i in range(len(syn)):
        np.testing.assert_array_equal(syn[i]["tokens"], syn_r[i]["tokens"])

    paths = []
    for j, n in enumerate((101, 67)):
        path = tmp_path / f"d{j}.bin"
        dataset.write_token_file(path, np.arange(n) * (j + 1) % 60000)
        paths.append(path)
    mm = [dataset.MemmapTokenDataset(p, 8) for p in paths]
    mm_r = [ref_ds.MemmapTokenDataset(p, 8) for p in paths]
    for a, b in zip(mm, mm_r):
        assert len(a) == len(b)
        for i in range(len(a)):
            np.testing.assert_array_equal(a[i]["tokens"], b[i]["tokens"])
    mix = dataset.MixtureDataset(mm, [3.0, 1.0], seed=4)
    mix_r = ref_ds.MixtureDataset(mm_r, [3.0, 1.0], seed=4)
    assert len(mix) == len(mix_r)
    for i in range(len(mix)):
        np.testing.assert_array_equal(mix[i]["tokens"], mix_r[i]["tokens"])


@pytest.mark.parametrize("prefetch", [0, 2])
def test_loader_yields_int64_batches_of_the_sampled_examples(prefetch):
    ds = dataset.SyntheticLMDataset(10, 6, 40, seed=1)
    dl = loader.DataLoader(ds, 4, "cpu", seed=2, prefetch=prefetch)
    order = iter(loader.ShardedSampler(10, 4, seed=2))
    it = iter(dl)
    for _ in range(3):
        batch = next(it)
        idx = next(order)
        assert batch["tokens"].dtype == torch.int64
        assert batch["tokens"].device.type == "cpu"
        want = np.stack([ds[int(i)]["tokens"] for i in idx])
        np.testing.assert_array_equal(batch["tokens"].numpy(), want)


def test_native_reader_is_not_ported():
    class Native:
        def __len__(self):
            return 4

        def read_batch(self, indices):
            return {}

    dl = loader.DataLoader(Native(), 2, "cpu", prefetch=0)
    with pytest.raises(NotImplementedError):
        next(iter(dl))
