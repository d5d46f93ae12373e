"""What surrounds the port's redesigned Hopper kernels and runs without a
card: the Winograd kernel's launch plan and ``eligible``, the order of its
filter transform, the packed and per-head attention kernels' launch plans,
the GroupNorm kernel's plan at the census shapes, and the build helper's
header-aware hash and kernel names. The kernels themselves are CUDA and run
only on the card, where ``chip_smoke.py`` (phases 2, 2c and 2d) holds them
and these plans against their plain versions and the built libraries.
"""

import ast
import os
import re

import numpy as np
import pytest
import torch

from clap2diffusion_tpu_torch.ops import cuda_build
from clap2diffusion_tpu_torch.ops import flash_attention as pfa
from clap2diffusion_tpu_torch.ops import groupnorm as pgn
from clap2diffusion_tpu_torch.ops import winograd as pw
from clap2diffusion_tpu_torch.ops import winograd_pallas as pwp

# One SD v1.5 UNet forward at CFG batch 2: the Conv3x3 calls the kernel takes
# (x shape, Cout), 47 calls over 16 shapes.
CENSUS = [
    ((2, 8, 8, 1280), 1280), ((2, 8, 8, 2560), 1280), ((2, 16, 16, 640), 1280),
    ((2, 16, 16, 1280), 1280), ((2, 16, 16, 1920), 1280), ((2, 16, 16, 2560), 1280),
    ((2, 32, 32, 320), 640), ((2, 32, 32, 640), 640), ((2, 32, 32, 960), 640),
    ((2, 32, 32, 1280), 640), ((2, 32, 32, 1920), 640), ((2, 32, 32, 1280), 1280),
    ((2, 64, 64, 320), 320), ((2, 64, 64, 640), 320), ((2, 64, 64, 960), 320),
    ((2, 64, 64, 640), 640),
]
# edges of the design: fewer tiles than a block's rows, one 16-channel step,
# a Cin that no split divides evenly, Cout under and off the block width,
# B = 1 with H != W, the bench's batch 16
RAGGED = [
    ((2, 4, 6, 32), 16), ((1, 2, 2, 16), 8), ((1, 6, 10, 48), 24), ((2, 8, 8, 80), 72),
    ((1, 4, 4, 112), 8), ((1, 10, 6, 208), 136), ((16, 64, 64, 320), 320),
    ((2, 16, 16, 1904), 1280),
]


@pytest.mark.parametrize("x_shape,cout", CENSUS + RAGGED)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_winograd_launch_plan_covers_the_work_once_and_fills_the_card(x_shape, cout, dtype):
    plan = pwp.launch_plan(x_shape, cout, dtype)
    b, h, w, cin = x_shape
    tiles = b * (h // 2) * (w // 2)
    m_blocks, n_blocks, split = plan["grid"]
    assert plan["smem_bytes"] <= pwp.MAX_SMEM
    assert plan["blocks"] == m_blocks * n_blocks * split and split == plan["split"]
    # every tile and output channel in exactly one block row / column
    assert (m_blocks - 1) * plan["tile_m"] < tiles <= m_blocks * plan["tile_m"]
    assert (n_blocks - 1) * plan["tile_n"] < cout <= n_blocks * plan["tile_n"]
    # every step of the Cin loop in exactly one split, none empty
    steps = cin // plan["step_k"]
    covered = [s for lo, hi in plan["k_ranges"] for s in range(lo, hi)]
    assert covered == list(range(steps)) and all(hi > lo for lo, hi in plan["k_ranges"])
    assert len(plan["k_ranges"]) == split <= pwp.MAX_SPLIT
    assert plan["partial_elems"] == (split * b * h * w * cout if split > 1 else 0)
    if dtype == torch.float32:
        assert split == 1 and plan["v_scratch_elems"] == 0
        return
    assert plan["v_scratch_elems"] == 16 * tiles * cin
    # at least one block per SM wherever tiles x Cout x Cin allow it
    base = m_blocks * n_blocks
    if base * min(steps, pwp.MAX_SPLIT) >= pwp.SM_COUNT:
        assert plan["blocks"] >= pwp.SM_COUNT
    if base >= 4 * pwp.SM_COUNT:
        assert split == 1  # no partials where the grid is many waves by itself


def test_winograd_launch_plan_is_a_pure_function_of_its_arguments():
    a = pwp.launch_plan((2, 8, 8, 1280), 1280, torch.bfloat16)
    assert a == pwp.launch_plan((2, 8, 8, 1280), 1280, torch.bfloat16)
    assert a["blocks"] >= 132 and a["grid"][:2] == (1, 20)
    # the caller's dict is its own: changing it leaves the next plan as it was
    a["split"] = 0
    assert pwp.launch_plan((2, 8, 8, 1280), 1280, torch.bfloat16)["split"] == 12
    # a last wave of 28 blocks on 132 SMs is evened out by a split
    assert pwp.launch_plan((2, 32, 32, 1280), 1280, torch.bfloat16)["grid"] == (8, 20, 4)
    assert pwp.launch_plan((16, 64, 64, 320), 320, torch.bfloat16)["split"] == 1


@pytest.mark.parametrize("x_shape,cout", CENSUS + RAGGED)
def test_kernel_eligible_takes_the_census_and_the_ragged_shapes(x_shape, cout):
    assert pwp.eligible(x_shape, x_shape[-1], cout)


@pytest.mark.parametrize("x_shape,cin,cout,ok", [
    ((2, 64, 64, 320), 320, 320, True), ((2, 8, 8, 2560), 2560, 1280, True),
    ((2, 64, 64, 4), 4, 320, False), ((2, 64, 64, 320), 320, 4, False),
    ((2, 63, 64, 320), 320, 320, False), ((1, 2, 2, 16), 16, 8, True),
    ((1, 2, 2, 24), 24, 8, False), ((1, 2, 2, 16), 16, 12, False), ((1, 0, 2, 16), 16, 8, False),
])
def test_kernel_eligible_limits_are_one_mma_depth_and_width(x_shape, cin, cout, ok):
    assert pwp.eligible(x_shape, cin, cout) == ok


@pytest.mark.parametrize("cin,cout,seed", [(16, 8, 0), (48, 24, 1), (320, 72, 2)])
def test_filter_transform_in_the_kernels_order_gives_winograd_filters_bits(cin, cout, seed):
    """``wino_filter`` sums G w G^T row by row, left to right, in fp32;
    ``filter_transform_steps`` is that order in plain PyTorch. On bf16
    weights it must give the bits of ``winograd_filter`` (the einsum)."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.normal(size=(3, 3, cin, cout)) / (9 * cin) ** 0.5)
                         .astype(np.float32)).bfloat16()
    steps = pwp.filter_transform_steps(w)
    assert steps.shape == (16, cin, cout) and steps.dtype == torch.float32
    assert torch.equal(steps.bfloat16(), pwp.winograd_filter(w, torch.bfloat16))
    # fp32 weights: the same up to the order of three fp32 adds
    w32 = torch.from_numpy(rng.normal(size=(3, 3, cin, cout)).astype(np.float32))
    torch.testing.assert_close(pwp.filter_transform_steps(w32),
                               pwp.winograd_filter(w32, torch.float32), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("cin,cout", [(32, 16), (16, 64), (48, 136)])
def test_winograd_filter_layout_is_cin_major_and_feeds_the_plain_products(cin, cout):
    """[16, Cin, Cout], contiguous: U[n] is the right-hand side of
    V[n] @ U[n] as it stands, and the kernel reads it through
    ldmatrix.trans without a transpose."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(size=(3, 3, cin, cout)).astype(np.float32))
    u = pwp.winograd_filter(w, torch.float32)
    assert u.shape == (16, cin, cout) and u.is_contiguous()
    assert torch.equal(u, pw.filter_transform(w))
    x = torch.from_numpy(rng.normal(size=(1, 4, 4, cin)).astype(np.float32))
    m = torch.matmul(pw.input_transform(x), u)  # [16, tiles, Cout]
    cols = [pw._at_combine([m[4 * i + j] for i in range(4)]) for j in range(4)]
    y = [pw._at_combine([cols[j][a] for j in range(4)]) for a in range(2)]
    torch.testing.assert_close(pw.interleave(y, 1, 2, 2),
                               pwp.plain_conv3x3_winograd_pallas(x, w), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,h,s,d,pack,ghost", [
    (2, 8, 4096, 40, 3, 1),   # the UNet's level-0 self-attention: 3 + 3 + 2 heads
    (4, 8, 4096, 40, 3, 1),   # stage 2's batch
    (1, 6, 1024, 40, 3, 0),
    (1, 4, 1024, 32, 4, 0), (1, 5, 1024, 32, 4, 3),
    (1, 2, 1024, 64, 2, 0), (1, 3, 1000, 64, 2, 1),
    (1, 3, 40, 40, 3, 0),     # S shorter than one key tile
    (1, 8, 1024, 16, 8, 0),   # a pack above 4 runs as groups of 4
    (1, 4, 1024, 64, 4, 0),   # d above 40: 2 heads a block (registers)
    (1, 4, 1024, 40, 4, 2),   # d = 40: 3 heads a block
])
def test_packed_launch_plan(b, h, s, d, pack, ghost):
    plan = pfa.packed_launch_plan(b, h, s, d, pack)
    kpack = plan["pack"]
    assert kpack == min(pack, pfa.max_pack(d))
    assert plan["groups"] == -(-h // kpack) and plan["ghost_heads"] == ghost
    assert sum(plan["heads_per_group"]) == h and max(plan["heads_per_group"]) <= kpack
    # every query row in exactly one block: 192 rows (three sub-tiles) each
    assert plan["query_rows"] == 192 and plan["sub_tiles"] == 3
    assert plan["grid"] == (-(-s // 192), b * plan["groups"])
    assert plan["blocks"] == plan["grid"][0] * plan["grid"][1]
    # one warpgroup (4 warps) per head
    assert plan["warps"] == 4 * kpack and plan["threads"] == 128 * kpack <= 1024
    assert plan["warps_per_head"] == 4 and plan["stages"] == 3
    assert plan["key_tiles"] == -(-s // 64)
    # Q: heads padded to a multiple of 16 columns; K/V: packed rows + a pad chunk
    q_tile = 192 * kpack * (-(-d // 16) * 16) * 2
    kv_tile = 64 * (kpack * d * 2 + 16)
    assert plan["smem_bytes"] == q_tile + 3 * 2 * kv_tile <= pfa.MAX_SMEM
    assert plan["waves"] == plan["blocks"] / 132


def test_packed_plan_at_the_serving_and_training_shapes_fills_whole_waves():
    plan = pfa.packed_launch_plan(2, 8, 4096, 40, 3)
    assert plan["blocks"] == 132 and plan["threads"] == 384 and plan["waves"] == 1.0
    assert plan["smem_bytes"] == 153_600
    assert pfa.packed_launch_plan(4, 8, 4096, 40, 3)["waves"] == 2.0
    assert pfa.packed_launch_plan(1, 4, 1024, 64, 4)["pack"] == 2
    assert [pfa.max_pack(d) for d in (8, 32, 40, 48, 64)] == [4, 4, 3, 2, 2]


def test_packed_eligible_answers_are_unchanged(monkeypatch):
    monkeypatch.setenv("C2D_PACKED_FLASH", "1")
    assert pfa.packed_eligible((2, 8, 4096, 40), (2, 8, 4096, 40), True)
    assert not pfa.packed_eligible((2, 8, 4096, 40), (2, 8, 4096, 40), False)
    assert not pfa.packed_eligible((2, 8, 1024, 80), (2, 8, 1024, 80), True)   # pack 1
    assert not pfa.packed_eligible((2, 8, 1000, 40), (2, 8, 1000, 40), True)   # S % 128
    assert not pfa.packed_eligible((2, 8, 4096, 40), (2, 8, 77, 40), True)     # cross
    monkeypatch.delenv("C2D_PACKED_FLASH")
    assert not pfa.packed_eligible((2, 8, 4096, 40), (2, 8, 4096, 40), True)


def _write(path, text):
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)


def test_library_path_follows_the_headers_a_source_includes(tmp_path, monkeypatch):
    """An edited header, also one reached through another header, changes
    the library's name, so the source is rebuilt; a header no source
    includes does not."""
    csrc = str(tmp_path)
    monkeypatch.setenv("C2D_TORCH_BUILD_DIR", str(tmp_path / "build"))
    _write(os.path.join(csrc, "k.cu"), '#include <cuda_runtime.h>\n#include "core.cuh"\nint k;\n')
    _write(os.path.join(csrc, "core.cuh"), '#pragma once\n  #  include "ptx.cuh"\nint c;\n')
    _write(os.path.join(csrc, "ptx.cuh"), "#pragma once\nint p;\n")
    _write(os.path.join(csrc, "other.cuh"), "int o;\n")
    assert cuda_build.source_files("k.cu", csrc) == ["k.cu", "core.cuh", "ptx.cuh"]
    first = cuda_build.library_path("k.cu", csrc)
    assert first == cuda_build.library_path("k.cu", csrc)
    assert os.path.dirname(first) == str(tmp_path / "build")
    _write(os.path.join(csrc, "other.cuh"), "int o2;\n")
    assert cuda_build.library_path("k.cu", csrc) == first
    _write(os.path.join(csrc, "ptx.cuh"), "#pragma once\nint p2;\n")
    second = cuda_build.library_path("k.cu", csrc)
    assert second != first
    _write(os.path.join(csrc, "core.cuh"), '#pragma once\n#include "ptx.cuh"\nint c2;\n')
    third = cuda_build.library_path("k.cu", csrc)
    assert third not in (first, second)
    _write(os.path.join(csrc, "k.cu"), '#include "core.cuh"\nint k2;\n')
    assert cuda_build.library_path("k.cu", csrc) not in (first, second, third)


def test_the_ports_sources_name_their_headers():
    assert cuda_build.source_files("packed_flash_attention.cu") == [
        "packed_flash_attention.cu", "attention_core.cuh", "ptx.cuh", "wgmma.cuh"]
    assert cuda_build.source_files("winograd.cu") == ["winograd.cu", "ptx.cuh"]
    assert cuda_build.source_files("flash_attention.cu") == [
        "flash_attention.cu", "attention_core.cuh", "ptx.cuh", "wgmma.cuh"]
    assert cuda_build.source_files("group_norm.cu") == ["group_norm.cu", "ptx.cuh"]


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN53_GLOBAL__N__a1b2c3d4_11_winograd_cu_0123abcd14wino_gemm_bf16ENS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN53_GLOBAL__N__a1b2c3d4_11_winograd_cu_0123abcd14wino_gemm_bf16ENS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 190 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN53_GLOBAL__N__a1b2c3d4_11_winograd_cu_0123abcd15wino_input_bf16ENS_6ParamsE' for 'sm_90a'
    8 bytes stack frame, 16 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 255 registers
ptxas info    : Compiling entry function '_ZN53_GLOBAL__N__a1b2c3d4_11_winograd_cu_0123abcd16wino_reduce_bf16ENS_6ParamsE' for 'sm_90a'
ptxas info    : Used 24 registers
ptxas info    : Compiling entry function '_ZN53_GLOBAL__N__a1b2c3d4_11_winograd_cu_0123abcd11wino_filterI13__nv_bfloat16fEEvPKT_PT0_ii' for 'sm_90a'
ptxas info    : Used 128 registers
ptxas info    : Compiling entry function '_ZN53_GLOBAL__N__a1b2c3d4_11_winograd_cu_0123abcd11wino_filterIffEEvPKT_PT0_ii' for 'sm_90a'
ptxas info    : Used 120 registers
ptxas info    : Compiling entry function '_ZN53_GLOBAL__N__a1b2c3d4_11_winograd_cu_0123abcd11wino_filterI13__nv_bfloat16S1_EEvPKT_PT0_ii' for 'sm_90a'
ptxas info    : Used 84 registers
ptxas info    : Compiling entry function '_ZN53_GLOBAL__N__a1b2c3d4_11_winograd_cu_0123abcd8wino_f32ENS_6ParamsE' for 'sm_90a'
ptxas info    : Used 116 registers
ptxas info    : Compiling entry function '_ZN60_GLOBAL__N__a1b2c3d4_25_packed_flash_attention_cu_0123abcd15packed_fwd_bf16ILi48EEEvNS_6ParamsE' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 126 registers
ptxas info    : Compiling entry function '_ZN60_GLOBAL__N__a1b2c3d4_25_packed_flash_attention_cu_0123abcd14packed_fwd_f32ENS_6ParamsE' for 'sm_90a'
ptxas info    : Used 64 registers
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__a1b2c3d4_22_flash_attention_bwd_cu_0123abcd17flash_bwd_dq_bf16ILi64EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Used 96 registers
"""


def test_ptxas_summary_names_the_redesigned_kernels():
    got = cuda_build.ptxas_summary(PTXAS_LOG)
    assert [k["kernel"] for k in got] == [
        "wino_gemm_bf16", "wino_input_bf16", "wino_reduce_bf16", "wino_filter<bf16,f32>",
        "wino_filter<f32,f32>", "wino_filter<bf16,bf16>", "wino_f32", "packed_fwd_bf16<48>",
        "packed_fwd_f32", "flash_bwd_dq_bf16<64>"]
    assert got[0] == {"kernel": "wino_gemm_bf16", "registers": 190, "spill_stores": 0,
                      "spill_loads": 0}
    assert got[1]["spill_stores"] == 16 and got[1]["spill_loads"] == 24
    assert got[7]["registers"] == 126 and got[8]["registers"] == 64


@pytest.mark.parametrize("d", [16, 40, 80])
def test_ptxas_summary_names_the_warp_specialised_forward(d):
    log = (f"ptxas info    : Compiling entry function '_ZN53_GLOBAL__N__a1b2c3d4_18_flash_"
           f"attention_cu_0123abcd17flash_fwd_ws_bf16ILi{d}EEEvNS_6WsArgsE' for 'sm_90a'\n"
           "ptxas info    : Used 168 registers, used 3 barriers\n")
    assert cuda_build.ptxas_summary(log) == [{"kernel": f"flash_fwd_ws_bf16<{d}>",
                                              "registers": 168}]


# GroupNorm(+SiLU) at the serving and training census: the SD v1.5 UNet's
# (H = W, C) at 32 groups (C/G from 10 to 80), the VAE decoder's (C/G from
# 4 to 16) at batch 1 and 2 (per-lane seeds), and the two slabs only the
# VAE encoder (img2img, inpainting) gives, NHWC.
UNET_GN = [(64, 320), (64, 640), (64, 960), (32, 320), (32, 640), (32, 960), (32, 1280),
           (32, 1920), (16, 640), (16, 1280), (16, 1920), (16, 2560), (8, 1280), (8, 2560)]
VAE_GN = [(64, 512), (128, 512), (256, 512), (256, 256), (512, 256), (512, 128)]
VAE_ENCODER_GN = [(256, 128), (128, 256)]
GN_CENSUS = ([((b, hw, hw, c), dt) for b in (2, 4) for hw, c in UNET_GN
              for dt in (torch.bfloat16, torch.float32)]
             + [((b, hw, hw, c), dt) for b in (1, 2) for hw, c in VAE_GN
                for dt in (torch.bfloat16, torch.float32)]
             + [((1, hw, hw, c), dt) for hw, c in VAE_ENCODER_GN
                for dt in (torch.bfloat16, torch.float32)])


@pytest.mark.parametrize("shape,dtype", GN_CENSUS)
@pytest.mark.parametrize("capacity", [132, 264])
def test_group_norm_plan_covers_every_row_and_channel_once(shape, dtype, capacity):
    b, h, w, c = shape
    plan = pgn.launch_plan(shape, dtype, 32, capacity)
    hw, bps, rpb = h * w, plan["blocks_per_sample"], plan["rows_per_block"]
    assert plan["smem_bytes"] <= pgn.MAX_SMEM == 232_448
    assert plan["grid"] == b * bps <= capacity
    # each sample's rows in exactly one block, no block empty
    rows = [r for k in range(bps) for r in range(k * rpb, min((k + 1) * rpb, hw))]
    assert rows == list(range(hw)) and (bps - 1) * rpb < hw
    # every channel in one 16-byte column, every (column, row lane) on a thread
    assert plan["vec_cols"] * plan["vec"] == c and plan["vec"] * torch.empty(
        (), dtype=dtype).element_size() == 16
    lanes = plan["lanes"]
    assert lanes == max(1, pgn.THREADS // plan["vec_cols"])
    assert plan["vec_cols"] * lanes <= pgn.THREADS * plan["items_per_thread"] <= 2 * pgn.THREADS
    # the block's kept rows and its per-lane sums fit its shared memory
    assert plan["keep_rows"] <= rpb
    assert plan["smem_bytes"] == lanes * 2 * c * 4 + plan["keep_rows"] * c * (16 // plan["vec"])
    assert plan["resident"] == (plan["keep_rows"] == rpb)
    assert plan["workspace_floats"] == plan["grid"] * 2 * 32  # (sum, sum of squares) a group
    # x from device memory once, and at most once more where it does not fit
    assert 1.0 <= plan["x_reads"] <= 2.0 and (plan["x_reads"] == 1.0) == plan["resident"]


@pytest.mark.parametrize("hw,c", UNET_GN)
def test_group_norm_plan_keeps_every_serving_unet_slab_resident(hw, c):
    """The UNet at CFG batch 2 in bf16: x is read from device memory once."""
    plan = pgn.launch_plan((2, hw, hw, c), torch.bfloat16, 32)
    assert plan["resident"] and plan["x_reads"] == 1.0 and plan["grid"] <= 132


@pytest.mark.parametrize("hw,c", VAE_ENCODER_GN)
def test_group_norm_plan_keeps_the_encoders_new_slabs_resident_in_bf16(hw, c):
    """The encoder's [1,256,256,128] and [1,128,128,256] (16.8 and 8.4 MB in
    bf16) fit the grid's shared memory: x is read once, on every SM."""
    plan = pgn.launch_plan((1, hw, hw, c), torch.bfloat16, 32)
    assert plan["resident"] and plan["x_reads"] == 1.0 and plan["grid"] == 132


def test_group_norm_plan_is_a_pure_function_and_refuses_what_the_kernel_does_not_take():
    a = pgn.launch_plan((2, 64, 64, 960), torch.bfloat16, 32)
    assert a is pgn.launch_plan((2, 64, 64, 960), torch.bfloat16, 32)  # cached
    assert a["grid"] == 132 and a["smem_bytes"] == 151_680 and a["lanes"] == 4
    small = pgn.launch_plan((2, 8, 8, 1280), torch.bfloat16, 32)
    assert small["grid"] == 10 and small["rows_per_block"] == 13  # 32 KB of x a block
    vae = pgn.launch_plan((1, 512, 512, 256), torch.bfloat16, 32)
    assert not vae["resident"] and vae["grid"] == 132 and vae["x_reads"] < 1.85
    for shape, groups in (((2, 8, 8, 12), 4), ((2, 8, 8, 8200), 8), ((2, 8, 8, 96), 7),
                          ((200, 8, 8, 64), 32)):
        with pytest.raises(ValueError):
            pgn.launch_plan(shape, torch.bfloat16, groups)


FLASH_DS = list(range(8, 161, 8)) + [512]


@pytest.mark.parametrize("d", FLASH_DS)
@pytest.mark.parametrize("sq,sk", [(4096, 4096), (1000, 777), (130, 65)])
def test_flash_launch_plan(d, sq, sk):
    b, h = 2, 3
    plan = pfa.flash_launch_plan(b, h, sq, sk, d)
    inst = plan["instance_d"]
    assert inst >= d and inst % 8 == 0
    assert inst == min(i for i in (*pfa.FLASH_INSTANCES, 512) if i >= d)
    assert plan["o_regs"] <= 128 and plan["smem_bytes"] <= pfa.MAX_SMEM
    rows = plan["query_rows"]
    assert plan["grid"] == (-(-sq // rows), b * h) and plan["blocks"] == plan["grid"][0] * b * h
    assert plan["key_tiles"] == -(-sk // plan["bk"])
    assert plan["threads"] == 128 * plan["warpgroups"]
    assert plan["waves"] == plan["blocks"] / 132
    if d <= 80:
        # a producer warpgroup and consumers of 64 rows (three up to 64, two
        # at 80) over a 2-stage ring of 128-key tiles, each row 128-byte
        # swizzled blocks of 64 columns; 9 mbarriers; 1 KB to align
        cons, stages = (3 if inst <= 64 else 2), 2
        assert plan["design"] == "ws" and rows == 64 * cons
        assert plan["consumers"] == plan["sub_tiles"] == cons
        assert plan["warpgroups"] == 1 + cons
        assert plan["bk"] == 128 and plan["stages"] == stages and plan["o_regs"] == inst // 2
        block = -(-inst // 64) * 128  # bytes of a row
        assert plan["smem_bytes"] == (rows + 2 * stages * 128) * block + 8 * (1 + 4 * stages) + 1024
    elif d <= 160:
        # three 64-row sub-tiles, one warpgroup each, on one 3-stage K/V ring
        assert plan["design"] == "narrow" and rows == 192
        assert plan["sub_tiles"] == 3 == plan["warpgroups"] == plan["consumers"]
        assert plan["bk"] == 64 and plan["o_regs"] == inst // 2 and plan["stages"] == 3
        q_tile = 192 * (-(-inst // 16) * 16) * 2
        kv_tile = 64 * (inst * 2 + 16)
        assert plan["smem_bytes"] == q_tile + 3 * 2 * kv_tile
    else:
        # 64 rows, four warpgroups over the keys of S and the columns of O
        assert plan["design"] == "wide" and rows == 64 and plan["bk"] == 64
        assert plan["warpgroups"] == 4 == plan["consumers"] and plan["o_regs"] == 64
        assert plan["smem_bytes"] == 64 * 512 * 2 + 2 * 64 * (512 * 2 + 16) + 64 * 64 * 2 + 4 * 64 * 4


def test_flash_launch_plan_at_the_serving_shapes():
    b1 = pfa.flash_launch_plan(2, 8, 4096, 4096, 40)
    assert b1["design"] == "ws" and b1["blocks"] == 22 * 16 and b1["o_regs"] == 20
    assert b1["consumers"] == 3 and b1["threads"] == 512
    assert b1["smem_bytes"] == 91_208 and b1["key_tiles"] == 32 and b1["stages"] == 2
    assert b1["waves"] == pytest.approx(2.667, abs=1e-3)
    b8 = pfa.flash_launch_plan(16, 8, 4096, 4096, 40)
    assert b8["blocks"] == 22 * 128 and b8["waves"] == pytest.approx(21.33, abs=1e-2)
    mid = pfa.flash_launch_plan(2, 8, 1024, 1024, 80)
    assert mid["design"] == "ws" and mid["blocks"] == 8 * 16 and mid["o_regs"] == 40
    assert mid["consumers"] == 2 and mid["threads"] == 384 and mid["stages"] == 2
    assert mid["smem_bytes"] == 164_936 and mid["waves"] < 1
    assert pfa.flash_launch_plan(16, 8, 1024, 1024, 80)["blocks"] == 8 * 128
    low = pfa.flash_launch_plan(2, 8, 256, 256, 160)
    assert low["design"] == "narrow" and low["o_regs"] == 80 and low["blocks"] == 2 * 16
    vae = pfa.flash_launch_plan(1, 1, 4096, 4096, 512)
    assert vae["blocks"] == 64 and vae["smem_bytes"] == 207_872 and vae["stages"] == 2
    assert vae["design"] == "wide"
    assert [pfa.flash_instance(d) for d in (8, 24, 40, 56, 72, 88, 136, 168)] == [
        16, 32, 40, 64, 80, 96, 160, 512]


@pytest.mark.parametrize("d", FLASH_DS)
def test_flash_design_by_head_dim(d):
    """The dispatch table by instance: warp-specialised up to 80, the narrow
    kernel from 96 to 160, the wide one for the VAE's 512; no option."""
    want = {16: "ws", 32: "ws", 40: "ws", 48: "ws", 64: "ws", 80: "ws", 96: "narrow",
            128: "narrow", 160: "narrow", 512: "wide"}[pfa.flash_instance(d)]
    assert pfa.flash_design(d) == want == pfa.flash_launch_plan(1, 1, 64, 64, d)["design"]


@pytest.mark.parametrize("d", [8, 40, 80, 96, 160, 512])
@pytest.mark.parametrize("sq", [1, 64, 65, 128, 130, 1000, 1024, 4096])
def test_flash_plan_gives_every_query_row_to_one_consumer(d, sq):
    """Block x's consumer c owns rows x*rows + 64c .. + 64: each row of Sq
    exactly once, and only the last block holds rows past Sq."""
    plan = pfa.flash_launch_plan(2, 3, sq, 77, d)
    owned = [x * plan["query_rows"] + 64 * c + r for x in range(plan["grid"][0])
             for c in range(plan["sub_tiles"]) for r in range(64)]
    assert plan["sub_tiles"] * 64 == plan["query_rows"]
    assert sorted(r for r in owned if r < sq) == list(range(sq))
    assert max(owned) < sq + plan["query_rows"]


@pytest.mark.parametrize("d", [16, 32, 40, 48, 64, 80])
def test_ws_plan_fits_the_sm(d):
    """Shared memory under 227 KB, and the setmaxnreg split within the
    65,536 registers the block is launched with: the registers the producer
    gives up cover what the consumers take, and a consumer holds S (64), O
    (d/2) and P (32 packed) in its share."""
    plan = pfa.flash_launch_plan(16, 8, 4096, 4096, d)
    inst = plan["instance_d"]
    assert plan["smem_bytes"] <= pfa.MAX_SMEM == 232_448
    launch = 65_536 // plan["threads"] // 8 * 8  # registers a thread at launch
    regs = pfa.ws_consumer_regs(inst)
    for n in (pfa.WS_PRODUCER_REGS, regs):
        assert n % 8 == 0 and 24 <= n <= 256
    assert 128 * (launch - pfa.WS_PRODUCER_REGS) >= 128 * plan["consumers"] * (regs - launch)
    assert 128 * pfa.WS_PRODUCER_REGS + 128 * plan["consumers"] * regs <= 65_536
    assert 64 + plan["o_regs"] + 32 <= regs - 24


def _forward_kernels():
    """The forward kernels' names in csrc/flash_attention.cu."""
    with open(os.path.join(cuda_build.CSRC_DIR, "flash_attention.cu"), encoding="utf-8") as f:
        src = f.read()
    bounds = r"__launch_bounds__\((?:[^()]|\([^()]*(?:\([^()]*\))?[^()]*\))*\)\s*"
    return re.findall(rf"__global__ void (?:{bounds})?(\w+)\(", src)


def _metric_patterns():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "perfbench", "metrics", "attn_fwd_roofline.b8.py")
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    return next(ast.literal_eval(node.value) for node in tree.body
                if isinstance(node, ast.Assign) and node.targets[0].id == "PATTERNS")


@pytest.mark.parametrize("kernel", ["flash_fwd_ws_bf16", "flash_fwd_bf16", "flash_fwd_wide_bf16",
                                    "flash_fwd_f32"])
def test_forward_kernel_names_match_the_roofline_metric_and_the_breakdown(kernel):
    """The attention-forward roofline finds the kernels' time by name
    (``perfbench/metrics/attn_fwd_roofline.*.py``'s PATTERNS, the
    breakdown's ``flash_fwd`` category in ``harness/reduce.py``): every
    forward kernel of the source keeps ``flash_fwd`` in its name."""
    from perfbench.harness import reduce
    assert kernel in _forward_kernels()
    assert any(re.search(p, kernel) for p in _metric_patterns())
    assert ("flash_attention", ("flash_fwd",)) in reduce.CATEGORIES
    assert "flash_fwd" in kernel
