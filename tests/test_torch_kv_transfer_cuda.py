"""KV-page export and import between two port batchers on the card, in
bf16 and int8 pools.

The prefill batcher's prompt pages, exported (one gather and one
device-to-host copy per wave) and imported by the decode batcher (one
``index_copy_`` per pool leaf per wave), must come back out of the
decode batcher's pool with the same bytes; the prefill side must launch
no paged-attention kernel (K4') and the decode side must launch it once
per layer and decode step; the decode batcher's greedy stream over the
imported pages must equal the prefill batcher's own over its cached
pages.  Marked ``cuda``: skips without a card (decided in the fixture).
This file imports no JAX.
"""

import pytest
import torch

from mpi_operator_tpu_torch.models.llama import llama2_tiny
from mpi_operator_tpu_torch.models.params import init_params
from mpi_operator_tpu_torch.ops import paged_attention as pa
from mpi_operator_tpu_torch.serving import ContinuousBatcher
from mpi_operator_tpu_torch.serving.batcher import prefix_page_digests

PAGE = 16


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda")


def _bytes(page):
    return {path: leaf.contiguous().view(torch.uint8).numpy().tobytes()
            for path, leaf in page["leaves"].items()}


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["auto", "int8"], ids=["bf16", "int8"])
def test_export_import_on_the_card(cuda_device, kv):
    cfg = llama2_tiny(dim=256, n_heads=2, n_layers=2, max_seq_len=512,
                      dtype=torch.bfloat16)
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device=cuda_device)
    prompt = [(11 * i) % 250 + 1 for i in range(20 * PAGE + 5)]
    digests = prefix_page_digests(prompt, PAGE)

    def batcher():
        return ContinuousBatcher(model, max_slots=4, page_size=PAGE,
                                 cache_blocks=128, kv_cache_dtype=kv,
                                 device=cuda_device).start()

    src, dst = batcher(), batcher()
    try:
        pa.LAUNCHES = 0
        src.submit(prompt, 1, timeout=120)
        assert pa.LAUNCHES == 0
        assert src.telemetry["dispatches_total"].value == 0
        pages = src.export_kv_pages(digests)
        assert [p["digest"] for p in pages] == digests
        assert all(leaf.device.type == "cpu" for p in pages
                   for leaf in p["leaves"].values())
        assert dst.import_kv_pages(pages) == \
            {"imported": len(digests), "deduped": 0, "rejected": 0}
        assert [_bytes(p) for p in dst.export_kv_pages(digests)] == \
            [_bytes(p) for p in pages]
        before = dst.telemetry["dispatches_total"].value
        out = dst.submit(prompt, 8, timeout=120)
        steps = dst.telemetry["dispatches_total"].value - before
        assert steps > 0 and pa.LAUNCHES == steps * cfg.n_layers
        assert dst.prefix_stats["hit_blocks"] == len(digests)
        assert out == src.submit(prompt, 8, timeout=120)
    finally:
        src.stop()
        dst.stop()
