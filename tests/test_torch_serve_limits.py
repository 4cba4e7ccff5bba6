"""The serving kernels' limits as the port states them on the CPU: the row
groups the fused verify tail (B8) launches over, the limits of the paged
adapter delta (B9), of the chunked prefill over either pool (B6, B6-int8)
of the paged decode (B5), of the int8 dequant matmul (B4) and of the
verify tail's width (B8) that the engine checks when it is built on the
card, the plain path, which has none of these limits, and the cases and
checks of the A/B tools for B4, B7, B8 and B9.

These are pure functions of shapes and dtypes (and tiny CPU engines),
so they run here; the card's side (an engine past B9's limits refused at
construction, an int8-KV engine past B6-int8's head width, a bf16-pool
engine past B5's and an f32 engine past the CUDA-core kernel's shared
memory refused at construction, a bf16 engine at 128-position blocks
serving, a 16-slot ``spec_k=8`` engine serving through two B8 launches a
verify) is in ``tests/test_torch_kernels_gpu.py``.
"""

import pytest
import torch

from trustworthy_dl_tpu_torch.models import gpt2
from trustworthy_dl_tpu_torch.ops import fused_dequant_matmul as fdm
from trustworthy_dl_tpu_torch.ops import paged_attention as pa
from trustworthy_dl_tpu_torch.quant import int8 as q8
from trustworthy_dl_tpu_torch.serve import ServeRequest, ServingEngine
from trustworthy_dl_tpu_torch.utils import adapter_ab, dequant_ab, trust_ab

pytestmark = pytest.mark.torchport

CFG = gpt2.GPT2Config(vocab_size=251, n_positions=64, n_layer=2, n_embd=32,
                      n_head=4, dtype=torch.float32)


def test_verify_row_groups_of_the_smoke_verify_is_one_launch():
    assert pa.verify_row_groups(40, 768) == [(0, 40)]


def test_verify_row_groups_split_past_the_kernel_limit():
    assert pa.verify_row_groups(144, 768) == [(0, 96), (96, 144)]


@pytest.mark.parametrize("b", [1, 40, 95, 96, 97, 100, 144, 192, 1000])
def test_verify_row_groups_tile_every_row_once(b):
    groups = pa.verify_row_groups(b, 768)
    assert groups[0][0] == 0 and groups[-1][1] == b
    assert all(hi == lo2 for (_, hi), (lo2, _) in zip(groups, groups[1:]))
    assert all(lo % pa.VERIFY_MAX_ROWS == 0 for lo, _ in groups)
    assert all(1 <= hi - lo <= pa.VERIFY_MAX_ROWS for lo, hi in groups)
    assert len(groups) == -(-b // pa.VERIFY_MAX_ROWS)


def _verify_smem_bytes_formula(rows, d, kc):
    """``vt_smem_bytes`` of ``csrc/paged_attention.cu``, spelled as the
    CUDA source spells it: rows16 * (D + 8) * 2 + VT_STAGES * VT_COLS *
    (KC + 8) * 2, normed's rows padded to 16, 3 stages of 128 columns."""
    return -(-rows // 16) * 16 * (d + 8) * 2 + 3 * 128 * (kc + 8) * 2


@pytest.mark.parametrize("d", [16, 96, 768, 1024, 1280, 1600, 4096, 5520,
                               5536])
def test_verify_group_rows_fit_the_kernels_shared_memory(d):
    """A B8 launch's rows at width D fit beside the kernel's smallest ring
    (three 64-deep stages) in the 227 KB a block may use, and 16 more would
    not (or the group is the 96-row maximum)."""
    rows = pa.verify_group_rows(d)
    limit = pa.VERIFY_SMEM_LIMIT
    assert rows % 16 == 0 and 0 <= rows <= pa.VERIFY_MAX_ROWS
    if rows:
        assert _verify_smem_bytes_formula(rows, d, 64) <= limit
    if rows < pa.VERIFY_MAX_ROWS:
        assert _verify_smem_bytes_formula(rows + 16, d, 64) > limit
    assert (pa.verify_kernel_limit(d, torch.bfloat16) is None) == (rows > 0)


def test_verify_group_rows_at_gpt2_widths():
    """GPT-2 small keeps 96 rows a launch (the smoke's verify is one
    launch); medium, large and XL take 80, 64 and 48."""
    assert [pa.verify_group_rows(d) for d in (768, 1024, 1280, 1600)] == \
        [96, 80, 64, 48]
    assert pa.verify_row_groups(96, 1024) == [(0, 80), (80, 96)]
    assert pa.verify_row_groups(40, 1600) == [(0, 40)]
    assert pa.verify_row_groups(160, 1280) == [(0, 64), (64, 128),
                                               (128, 160)]


@pytest.mark.parametrize("rank,d,dtype,needle", [
    (65, 768, torch.bfloat16, "rank 65"),
    (0, 768, torch.bfloat16, "rank 0"),
    (16, 40, torch.bfloat16, "D=40"),
    (16, 768, torch.float32, "bf16"),
    (64, 11344, torch.bfloat16, "shared memory"),
])
def test_adapter_kernel_limit_names_what_it_refuses(rank, d, dtype, needle):
    reason = pa.adapter_kernel_limit(rank, d, dtype)
    assert reason is not None and needle in reason


@pytest.mark.parametrize("rank", [1, 16, 64])
def test_adapter_kernel_limit_takes_gpt2_small(rank):
    assert pa.adapter_kernel_limit(rank, 768, torch.bfloat16) is None


@pytest.mark.parametrize("rank", [1, 16, 64])
@pytest.mark.parametrize("name", ["gpt2-medium", "gpt2-large", "gpt2-xl"])
def test_adapter_kernel_limit_takes_every_gpt2_width(name, rank):
    """Every width the port defines (n_embd 1024, 1280, 1600; 768 above)
    at every rank up to 64."""
    d = gpt2.GPT2_SIZES[name]["n_embd"]
    assert pa.adapter_kernel_limit(rank, d, torch.bfloat16) is None


def test_adapter_kernel_limit_edge_at_rank_64():
    """Past the GPT-2 widths, shared memory bounds D through the x tile:
    rank 64 takes D = 11,328 and refuses the next multiple of 16."""
    assert pa.adapter_kernel_limit(64, 11328, torch.bfloat16) is None
    assert "shared memory" in pa.adapter_kernel_limit(64, 11344,
                                                      torch.bfloat16)


def _adapter_smem_bytes_formula(rank, d, tile_t, itemsize):
    """``smem_bytes`` of ``csrc/adapter_delta.cu``, spelled as the CUDA
    source spells it: sizeof(float) * (WARPS * TT * RPAD + RPAD * TT) +
    sizeof(bf16) * TT * D + sizeof(P) * r * NCOL, with 8 warps, 256
    columns and RPAD the instance dispatch_rank picks (8, 16, 32, 64)."""
    rpad = 8 if rank <= 8 else 16 if rank <= 16 else 32 if rank <= 32 \
        else 64
    return 4 * (8 * tile_t * rpad + rpad * tile_t) + 2 * tile_t * d \
        + itemsize * rank * 256


@pytest.mark.parametrize("rank,d,tile_t,itemsize", [
    (16, 768, 1, 2), (16, 768, 8, 1), (64, 1600, 8, 2), (4, 64, 8, 2),
    (33, 128, 1, 1), (1, 16, 1, 2)])
def test_adapter_smem_bytes_match_the_cuda_formula(rank, d, tile_t,
                                                   itemsize):
    assert pa.adapter_smem_bytes(rank, d, tile_t, itemsize) == \
        _adapter_smem_bytes_formula(rank, d, tile_t, itemsize)


def test_plain_engine_serves_past_the_kernel_rank_limit():
    """On the CPU the plain path takes any rank: a rank-128 engine builds
    and serves one adapter request to completion, launching nothing."""
    params = gpt2.init_params(CFG, torch.Generator().manual_seed(0))
    pa.reset_launch_counts()
    engine = ServingEngine(params, CFG, max_slots=2, max_seq=48,
                           block_size=8, prefill_chunk=16, device="cpu",
                           adapter_rank=128, adapter_pool_pages=1,
                           adapter_map={"t": "ad-t"})
    rid = engine.submit(ServeRequest(prompt=[3, 1, 4, 1, 5, 9, 2, 6],
                                     max_new_tokens=5, tenant="t"))
    results = engine.run_until_idle()
    assert results[rid].status == "completed"
    assert results[rid].adapter == "ad-t"
    assert len(results[rid].tokens) == 5
    assert all(fn.launches == 0 for fn in pa.KERNEL_WRAPPERS)


@pytest.mark.parametrize("dh,bsz,dtype,needle", [
    (40, 16, torch.bfloat16, "multiple of 16"),
    (8, 16, torch.bfloat16, "multiple of 16"),
    (0, 16, torch.bfloat16, "Dh=0"),
    (144, 16, torch.bfloat16, "Dh=144 > 128"),
    (256, 16, torch.bfloat16, "Dh=256"),
    (64, 0, torch.bfloat16, "block size 0"),
    (64, 16, torch.float16, "bf16 or f32"),
    (512, 16, torch.float32, "shared memory"),
    (64, 256, torch.float32, "shared memory"),
])
def test_prefill_int8_kernel_limit_names_what_it_refuses(dh, bsz, dtype,
                                                         needle):
    reason = pa.prefill_int8_kernel_limit(dh, bsz, dtype)
    assert reason is not None and needle in reason


@pytest.mark.parametrize("dh,bsz,dtype", [
    (64, 16, torch.bfloat16),      # GPT-2 small at the serve block size
    (64, 8, torch.bfloat16),
    (64, 48, torch.bfloat16),      # a block size that does not divide 64
    (64, 1, torch.bfloat16),
    (16, 16, torch.bfloat16),
    (128, 512, torch.bfloat16),
    (64, 16, torch.float32),
    (10, 8, torch.float32),        # the CUDA-core kernel takes any Dh
])
def test_prefill_int8_kernel_limit_takes(dh, bsz, dtype):
    assert pa.prefill_int8_kernel_limit(dh, bsz, dtype) is None


@pytest.mark.parametrize("n_embd,n_head", [(32, 4), (40, 2), (32, 1)])
def test_plain_int8_engine_serves_at_any_head_width(n_embd, n_head):
    """On the CPU the int8 pool's plain path takes any Dh (8, 20 and 32
    here; the first two are past the card kernel's limit): the engine
    builds, keeps its int8 pool and serves a request to completion,
    launching nothing."""
    cfg = gpt2.GPT2Config(vocab_size=251, n_positions=64, n_layer=2,
                          n_embd=n_embd, n_head=n_head, dtype=torch.float32)
    params = gpt2.init_params(cfg, torch.Generator().manual_seed(0))
    pa.reset_launch_counts()
    engine = ServingEngine(params, cfg, max_slots=2, max_seq=48,
                           block_size=8, kv_dtype="int8",
                           kv_parity_check=False, device="cpu")
    rid = engine.submit(ServeRequest(prompt=[3, 1, 4, 1, 5, 9, 2, 6],
                                     max_new_tokens=5))
    results = engine.run_until_idle()
    assert engine.kv_dtype == "int8"
    assert results[rid].status == "completed"
    assert len(results[rid].tokens) == 5
    assert all(fn.launches == 0 for fn in pa.KERNEL_WRAPPERS)


@pytest.mark.parametrize("dh,t,dtype,needle", [
    (20, 1, torch.bfloat16, "Dh=20"),
    (144, 1, torch.bfloat16, "Dh=144 > 128"),
    (0, 1, torch.bfloat16, "Dh=0"),
    (64, 9, torch.bfloat16, "T=9"),
    (64, 9, torch.float32, "T=9"),
    (64, 0, torch.bfloat16, "T=0"),
    (64, 1, torch.float16, "bf16 or f32"),
    (64, 1, torch.int8, "bf16 or f32"),
    (0, 1, torch.float32, "Dh=0"),
])
def test_decode_kernel_limit_names_what_it_refuses(dh, t, dtype, needle):
    reason = pa.decode_kernel_limit(dh, t, dtype, 16)
    assert reason is not None and needle in reason


@pytest.mark.parametrize("dh,t,dtype", [
    (64, 1, torch.bfloat16),       # GPT-2 small's decode tick
    (64, 5, torch.bfloat16),       # its spec_k=4 verify window
    (64, pa.QROWS, torch.bfloat16),
    (16, 1, torch.bfloat16),
    (128, pa.QROWS, torch.bfloat16),
    (20, 1, torch.float32),        # the CUDA-core kernel takes any Dh
    (64, pa.QROWS, torch.float32),
])
def test_decode_kernel_limit_takes(dh, t, dtype):
    assert pa.decode_kernel_limit(dh, t, dtype, 16) is None


def test_plain_bf16_engine_serves_past_the_decode_kernel_limit():
    """Dh = 20 is past B5's bf16-query kernel (a card engine refuses it at
    construction); on the CPU the plain path serves it over a bf16 pool,
    launching nothing."""
    cfg = gpt2.GPT2Config(vocab_size=251, n_positions=64, n_layer=2,
                          n_embd=40, n_head=2, dtype=torch.bfloat16)
    assert "Dh=20" in pa.decode_kernel_limit(cfg.head_dim, pa.QROWS,
                                             cfg.dtype, 8)
    params = gpt2.init_params(cfg, torch.Generator().manual_seed(0))
    pa.reset_launch_counts()
    engine = ServingEngine(params, cfg, max_slots=2, max_seq=48,
                           block_size=8, device="cpu")
    rid = engine.submit(ServeRequest(prompt=[3, 1, 4, 1, 5, 9, 2, 6],
                                     max_new_tokens=5))
    results = engine.run_until_idle()
    assert engine.kv_dtype == "model"
    assert engine.scheduler.kv.k.dtype == torch.bfloat16
    assert results[rid].status == "completed"
    assert len(results[rid].tokens) == 5
    assert all(fn.launches == 0 for fn in pa.KERNEL_WRAPPERS)


# B6 over a model-dtype pool: the bf16-query tensor-core kernel
# takes any block size; the CUDA-core kernel (f32 q) stages at least one
# block a stage in 48 KB, and B5's f32 branch reads the same bytes.


def _attn_smem_bytes_formula(q_tile, dh, kt):
    """``attn_smem_bytes`` of ``csrc/paged_attention.cu``, spelled as the
    CUDA source spells it: sizeof(float) * (2 * q_tile * Dh + kt * (Dh + 1)
    + kt * Dh + q_tile * kt + 3 * q_tile + 2 * kt)."""
    return 4 * (2 * q_tile * dh + kt * (dh + 1) + kt * dh + q_tile * kt
                + 3 * q_tile + 2 * kt)


@pytest.mark.parametrize("q_tile,dh,kt", [(8, 64, 16), (8, 64, 64),
                                          (1, 128, 128), (5, 20, 48),
                                          (8, 512, 16)])
def test_template_smem_bytes_match_the_cuda_formula(q_tile, dh, kt):
    assert pa.attn_template_smem_bytes(q_tile, dh, kt) == \
        _attn_smem_bytes_formula(q_tile, dh, kt)


def test_template_limit_edges_at_dh64_and_dh128():
    """The CUDA-core kernel at QROWS rows: Dh = 64 fits blocks up to 80
    positions, Dh = 128 up to 38, and the limit functions refuse exactly
    past those."""
    for dh, largest in ((64, 80), (128, 38)):
        fits = [b for b in range(1, 200)
                if _attn_smem_bytes_formula(pa.QROWS, dh, b)
                <= pa.STATIC_SMEM_LIMIT]
        assert max(fits) == largest and fits == list(range(1, largest + 1))
        assert pa.prefill_kernel_limit(dh, largest, torch.float32) is None
        assert "shared memory" in pa.prefill_kernel_limit(dh, largest + 1,
                                                          torch.float32)
        assert pa.decode_kernel_limit(dh, pa.QROWS, torch.float32,
                                      largest) is None
        assert "shared memory" in pa.decode_kernel_limit(
            dh, pa.QROWS, torch.float32, largest + 1)


@pytest.mark.parametrize("dh,bsz,dtype,needle", [
    (40, 16, torch.bfloat16, "multiple of 16"),
    (144, 128, torch.bfloat16, "Dh=144 > 128"),
    (64, 0, torch.bfloat16, "block size 0"),
    (64, 16, torch.float16, "bf16 or f32"),
    (0, 16, torch.float32, "Dh=0"),
    (64, 128, torch.float32, "75360 bytes"),    # past the 48 KB template
    (128, 39, torch.float32, "shared memory"),
])
def test_prefill_kernel_limit_names_what_it_refuses(dh, bsz, dtype, needle):
    reason = pa.prefill_kernel_limit(dh, bsz, dtype)
    assert reason is not None and needle in reason


@pytest.mark.parametrize("dh,bsz,dtype", [
    (64, 16, torch.bfloat16),      # GPT-2 small at the serve block size
    (64, 128, torch.bfloat16),     # past the old template's 80 positions
    (128, 128, torch.bfloat16),
    (64, 48, torch.bfloat16),      # a block size that does not divide 64
    (16, 1, torch.bfloat16),
    (64, 16, torch.float32),       # the CUDA-core kernel at its blocks
    (10, 8, torch.float32),
])
def test_prefill_kernel_limit_takes(dh, bsz, dtype):
    assert pa.prefill_kernel_limit(dh, bsz, dtype) is None


@pytest.mark.parametrize("dh,t,bsz,needle", [
    (64, pa.QROWS, 128, "75360 bytes"),
    (128, 1, 128, "shared memory"),
    (64, pa.QROWS, 88, "shared memory"),
    (64, 1, 0, "block size 0"),
])
def test_decode_kernel_limit_f32_names_what_it_refuses(dh, t, bsz, needle):
    reason = pa.decode_kernel_limit(dh, t, torch.float32, bsz)
    assert reason is not None and needle in reason


@pytest.mark.parametrize("dh,t,dtype,bsz", [
    (64, pa.QROWS, torch.float32, 16),
    (64, 1, torch.float32, 88),    # one row fits where QROWS rows do not
    (64, pa.QROWS, torch.float32, 80),
    (20, 3, torch.float32, 48),
    (64, pa.QROWS, torch.bfloat16, 1),   # the split-K kernel: any block
    (64, pa.QROWS, torch.bfloat16, 48),
    (64, pa.QROWS, torch.bfloat16, 128),
    (128, 1, torch.bfloat16, 512),
])
def test_decode_kernel_limit_takes_at_block_sizes(dh, t, dtype, bsz):
    assert pa.decode_kernel_limit(dh, t, dtype, bsz) is None


def test_plain_bf16_engine_serves_at_block_128():
    """On the CPU the plain path serves a bf16 model over 128-position
    blocks (the card's kernels take them too), launching nothing."""
    cfg = gpt2.GPT2Config(vocab_size=251, n_positions=256, n_layer=2,
                          n_embd=64, n_head=2, dtype=torch.bfloat16)
    assert pa.prefill_kernel_limit(cfg.head_dim, 128, cfg.dtype) is None
    params = gpt2.init_params(cfg, torch.Generator().manual_seed(0))
    pa.reset_launch_counts()
    engine = ServingEngine(params, cfg, max_slots=2, max_seq=256,
                           block_size=128, device="cpu")
    rid = engine.submit(ServeRequest(prompt=list(range(3, 140)),
                                     max_new_tokens=5))
    results = engine.run_until_idle()
    assert results[rid].status == "completed"
    assert len(results[rid].tokens) == 5
    assert all(fn.launches == 0 for fn in pa.KERNEL_WRAPPERS)


# B4: bf16 x, K and N multiples of 16; the engine reads the same function
# for each of its four block matrices whenever it reaches B4.


@pytest.mark.parametrize("k,n,dtype,needle", [
    (768, 768, torch.float32, "x must be bf16"),
    (768, 768, torch.float16, "x must be bf16"),
    (40, 768, torch.bfloat16, "K=40"),
    (768, 40, torch.bfloat16, "N=40"),
    (0, 768, torch.bfloat16, "K=0"),
    (768, 8, torch.bfloat16, "N=8"),
    (100, 400, torch.bfloat16, "K=100"),
])
def test_dequant_kernel_limit_names_what_it_refuses(k, n, dtype, needle):
    reason = fdm.dequant_kernel_limit(k, n, dtype)
    assert reason is not None and needle in reason


@pytest.mark.parametrize("n_embd", [32, 64, 80, 96, 768])
def test_dequant_kernel_limit_takes_the_block_matrices(n_embd):
    """GPT-2 small's four matrices and n_embd 32/64/80/96 (80 and 96 are
    not multiples of 64, which the previous kernel needed) at bf16."""
    cfg = gpt2.GPT2Config(vocab_size=251, n_positions=64, n_layer=1,
                          n_embd=n_embd, n_head=2, dtype=torch.bfloat16)
    shapes = q8.block_matrix_shapes(cfg)
    assert sorted(shapes.values()) == sorted(
        [(n_embd, 3 * n_embd), (n_embd, n_embd), (n_embd, 4 * n_embd),
         (4 * n_embd, n_embd)])
    for k, n in shapes.values():
        assert fdm.dequant_kernel_limit(k, n, torch.bfloat16) is None


@pytest.mark.parametrize("n_embd,n_head,dtype", [
    (768, 12, torch.bfloat16), (96, 2, torch.bfloat16),
    (96, 2, torch.float32), (40, 2, torch.bfloat16), (72, 4, torch.bfloat16),
])
@pytest.mark.parametrize("weight_dtype,spec_k", [("model", 0), ("int8", 0),
                                                 ("model", 4), ("int8", 4)])
def test_dequant_engine_limit_refuses_exactly_what_the_wrapper_would(
        n_embd, n_head, dtype, weight_dtype, spec_k):
    """The engine's predicate is None when the engine never reaches B4
    (model-dtype weights, no draft) and otherwise names the first block
    matrix the wrapper's limit refuses, or None when it refuses none."""
    cfg = gpt2.GPT2Config(vocab_size=251, n_positions=64, n_layer=1,
                          n_embd=n_embd, n_head=n_head, dtype=dtype)
    got = q8.dequant_engine_limit(cfg, weight_dtype, spec_k)
    if weight_dtype == "model" and spec_k == 0:
        assert got is None
        return
    refused = [(name, fdm.dequant_kernel_limit(k, n, dtype))
               for name, (k, n) in q8.block_matrix_shapes(cfg).items()
               if fdm.dequant_kernel_limit(k, n, dtype) is not None]
    if not refused:
        assert got is None
    else:
        name, reason = refused[0]
        assert got.startswith(name) and got.endswith(reason)


@pytest.mark.parametrize("d,dtype,needle", [
    (768, torch.float32, "bf16"), (40, torch.bfloat16, "D=40"),
    (0, torch.bfloat16, "D=0"), (8, torch.bfloat16, "D=8"),
    (5536, torch.bfloat16, "shared memory"),
])
def test_verify_kernel_limit_names_what_it_refuses(d, dtype, needle):
    reason = pa.verify_kernel_limit(d, dtype)
    assert reason is not None and needle in reason


@pytest.mark.parametrize("d", [16, 48, 96, 768, 1024])
def test_verify_kernel_limit_takes_multiples_of_16(d):
    assert pa.verify_kernel_limit(d, torch.bfloat16) is None


@pytest.mark.parametrize("n_embd,dtype", [
    (768, torch.bfloat16), (96, torch.bfloat16), (40, torch.bfloat16),
    (72, torch.bfloat16), (768, torch.float32), (96, torch.float16),
])
def test_spec_engine_that_b4_takes_b8_takes(n_embd, dtype):
    """A ``spec_k > 0`` engine reaches B8 with D = n_embd; the engine checks
    only B4's limits at construction, which already hold B8's: every
    configuration B4's predicate takes, B8's limit takes too."""
    cfg = gpt2.GPT2Config(vocab_size=251, n_positions=64, n_layer=1,
                          n_embd=n_embd, n_head=2, dtype=dtype)
    if q8.dequant_engine_limit(cfg, "model", 4) is None:
        assert pa.verify_kernel_limit(n_embd, dtype) is None


def test_dequant_ab_cases_and_tolerance():
    """``utils/dequant_ab``'s cases import without a card: GPT-2 small's
    four matrices at M = 1, 8, 16, 64 and 320, n_embd 96's two at M = 8
    (shapes the parent's 64-multiple kernel refused), the smoke's bound,
    and a bound that is the weight's bytes at M = 8."""
    labels = [c[0] for c in dequant_ab.CASES]
    assert len(labels) == len(set(labels)) == 4 * 5 + 2
    for _, k, n, m in dequant_ab.CASES:
        assert fdm.dequant_kernel_limit(k, n, torch.bfloat16) is None
        assert m >= 1
    d96 = [(k, n) for label, k, n, _ in dequant_ab.CASES
           if label.startswith("d96")]
    assert d96 == [(96, 288), (384, 96)]
    assert all(k % 64 or n % 64 for k, n in d96)
    assert dequant_ab.DQ_RTOL == 1e-5
    assert dequant_ab.bound_ms(8, 3072, 768) == pytest.approx(
        (3072 * 768 + 4 * 768 + 2 * 8 * 3072 + 4 * 8 * 768) / 3.35e12 * 1e3)


def test_adapter_ab_cases_and_bound():
    """``utils/adapter_ab``'s cases import without a card: the smoke's
    three launches and the 16-row decode at rank 16, rank 64 at GPT-2
    small's, medium's and XL's widths, every one inside B9's limits (the
    parent's kernel refused rank 64 past D = 768); the smoke's tolerance
    and its bound for the decode launch."""
    labels = [c[0] for c in adapter_ab.CASES]
    assert len(labels) == len(set(labels)) == 8
    for _, d, rank, t, pages in adapter_ab.CASES:
        assert pa.adapter_kernel_limit(rank, d, torch.bfloat16) is None
        assert t >= 1 and all(0 <= p < adapter_ab.POOL_PAGES for p in pages)
    assert {(d, r) for _, d, r, _, _ in adapter_ab.CASES} == {
        (768, 16), (768, 64), (1024, 64), (1600, 64)}
    assert adapter_ab.ADAPTER_RTOL == 1e-5
    assert adapter_ab.bound_ms(8, 1, 768, 16, adapter_ab.SMOKE_PAGES, 2,
                               False) == pytest.approx(
        (8 * 768 * 6 + 8 * 4 + 5 * 2 * 768 * 16 * 2) / 3.35e12 * 1e3)


@pytest.mark.parametrize("scaled", [False, True])
def test_adapter_ab_library_call_is_the_delta_in_bf16(scaled):
    """The yardstick computes the twin's function: the page gather and two
    bf16 products, scaled, within bf16 rounding of ``adapter_delta_plain``
    (it rounds h to bf16, which the kernel may not), zero-page rows
    exactly 0.0."""
    gen = torch.Generator().manual_seed(3)
    a, b, sa, sb = adapter_ab.site_pools(64, 8, "int8" if scaled else "bf16",
                                         gen, torch.device("cpu"))
    x = torch.randn(3, 5, 64, generator=gen).to(torch.bfloat16)
    pages = torch.tensor([2, 0, 4], dtype=torch.int32)
    got = adapter_ab.library_delta(x, a, b, pages, sa, sb)
    ref = pa.adapter_delta_plain(x, a, b, pages, sa, sb)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert bool((got[1] == 0.0).all())
    torch.testing.assert_close(got, ref, rtol=2.0 ** -6,
                               atol=2.0 ** -6 * float(ref.abs().max()))


def test_trust_ab_cases_and_bounds():
    """``utils/trust_ab``'s cases import without a card: B7 at the serve
    path's two launches (a decode tick's 8 rows and a prompt's last
    chunk's 1 of GPT-2's vocab), 4 and 16 rows and an odd V; B8 at the
    smoke's spec verify, 8 and 96 rows (one launch's most) and n_embd 96,
    each one launch inside B8's limits; the smoke's tolerance and its
    bounds at B7's and B8's main launches."""
    labels = [c[0] for c in trust_ab.TRUST_CASES] + \
        [c[0] for c in trust_ab.VERIFY_CASES]
    assert len(labels) == len(set(labels)) == 9
    shapes = {(b, v) for _, b, v in trust_ab.TRUST_CASES}
    assert {(8, 50257), (1, 50257)} <= shapes
    assert any(v % 2 and b > 1 for b, v in shapes)
    for _, b, d, v in trust_ab.VERIFY_CASES:
        assert pa.verify_kernel_limit(d, torch.bfloat16) is None
        assert pa.verify_row_groups(b, d) == [(0, b)]
    assert {d for _, _, d, _ in trust_ab.VERIFY_CASES} == {768, 96}
    assert trust_ab.ENTROPY_ATOL == 1e-4
    assert trust_ab.trust_bound_ms(8, 50257) == pytest.approx(
        (8 * 50257 * 4 + 2 * 8 * 4) / 3.35e12 * 1e3)
    assert trust_ab.verify_bound_ms(40, 768, 50257) == pytest.approx(
        (50257 * 768 * 2 + 40 * 768 * 2 + 40 * 50257 * 4 + 2 * 40 * 4)
        / 3.35e12 * 1e3)


@pytest.mark.parametrize("kernel", ["B7", "B8"])
def test_trust_ab_checks_take_the_twin_and_refuse_a_moved_margin(kernel):
    """``utils/trust_ab`` holds a build's outputs as ``chip_smoke.py``
    does: the plain twin's own outputs on its inputs (each case's maximum
    duplicated, margin 0) pass, and the same outputs with one margin moved
    by one f32 step fail."""
    gen = torch.Generator().manual_seed(7)
    cpu = torch.device("cpu")
    if kernel == "B7":
        logits = trust_ab.trust_inputs(5, 700, gen, cpu)
        got = pa.logit_trust_stats_plain(logits)

        def check(out):
            return trust_ab.trust_check(out, logits)
    else:
        normed, head = trust_ab.verify_inputs(3, 64, 700, gen, cpu)
        got = pa.fused_verify_tail_plain(normed, head)

        def check(out):
            return trust_ab.verify_check(out, normed, head)
    margin = got[-1]
    assert float(margin[0 if kernel == "B7" else -1]) == 0.0
    assert check(got)["within_tolerance"]
    moved = margin.clone()
    moved[0] = torch.nextafter(moved[0], torch.tensor(1.0))
    assert not check((*got[:-1], moved))["within_tolerance"]


def test_trust_ab_library_calls_give_the_margin():
    """The yardsticks compute the twins' statistics: top-2 of the same
    logits gives the twin's margin exactly, and logsumexp its logZ; B8's
    takes the bf16 product first."""
    gen = torch.Generator().manual_seed(8)
    logits = trust_ab.trust_inputs(4, 300, gen, torch.device("cpu"))
    lse, top2 = trust_ab.library_trust(logits)
    _, margin = pa.logit_trust_stats_plain(logits)
    assert torch.equal(top2.values[:, 0] - top2.values[:, 1], margin)
    torch.testing.assert_close(
        lse, torch.log(torch.exp(logits.double()).sum(-1)).float())
    normed, head = trust_ab.verify_inputs(2, 32, 300, gen,
                                          torch.device("cpu"))
    _, top2 = trust_ab.library_verify(normed, head.T)
    assert top2.values.dtype == torch.float32
    assert top2.values.shape == (2, 2)


def test_plain_engine_serves_d96_int8_weights_and_spec():
    """On the CPU the plain twins take any width; a bf16 n_embd 96 engine
    with int8 weights and one with ``spec_k=4`` build and serve, launching
    nothing (the card's kernels take these widths too)."""
    cfg = gpt2.GPT2Config(vocab_size=251, n_positions=64, n_layer=2,
                          n_embd=96, n_head=2, dtype=torch.bfloat16)
    assert q8.dequant_engine_limit(cfg, "int8", 4) is None
    params = gpt2.init_params(cfg, torch.Generator().manual_seed(0))
    for knobs in (dict(weight_dtype="int8"), dict(spec_k=4)):
        pa.reset_launch_counts()
        fdm.dequant_matmul.launches = 0
        engine = ServingEngine(params, cfg, max_slots=2, max_seq=48,
                               block_size=8, device="cpu", **knobs)
        rid = engine.submit(ServeRequest(prompt=[3, 1, 4, 1, 5, 9, 2, 6],
                                         max_new_tokens=5))
        results = engine.run_until_idle()
        assert results[rid].status == "completed"
        assert len(results[rid].tokens) == 5
        assert all(fn.launches == 0 for fn in pa.KERNEL_WRAPPERS)
        assert fdm.dequant_matmul.launches == 0
