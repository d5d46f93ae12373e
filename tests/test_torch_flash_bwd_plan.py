"""The flash-attention backward's launch plan, and what surrounds its Hopper
kernel without a card: the instance a head dim runs on, what the plan
refuses, the headers the source's library is hashed with, and the kernel
names the build log gives. The kernel itself is CUDA and runs only on the
card, where ``chip_smoke.py`` (phase 2b) holds it against its plain version
and this plan against the built library's at every shape it runs.
"""

import pytest

from clap2diffusion_tpu_torch.ops import cuda_build
from clap2diffusion_tpu_torch.ops import flash_attention as pfa

# (b, h, sq, sk): the training census (stage 2 at batch 4, stage 3 at batch 2)
# and ragged ones: Sq != Sk, off the 64-row tile, shorter than a block's rows
SHAPES = [(4, 8, 4096, 4096), (4, 8, 1024, 1024), (4, 8, 256, 256), (2, 8, 4096, 4096),
          (1, 2, 1000, 777), (1, 2, 130, 65), (1, 2, 70, 300), (1, 2, 200, 100)]
DS = [8, 16, 24, 40, 48, 64, 80, 96, 128, 160]
MAX_SMEM = 232_448  # bytes of shared memory one block may use on an H100
REGS_PER_SM = 65_536


def _rows_once(blocks: int, rows: int, n: int) -> list:
    """The rows [0, n) that `blocks` runs of `rows` rows cover, in order."""
    return [r for i in range(blocks) for r in range(i * rows, min((i + 1) * rows, n))]


@pytest.mark.parametrize("b,h,sq,sk", SHAPES)
@pytest.mark.parametrize("d", DS)
def test_flash_bwd_plan_covers_every_key_and_query_once(b, h, sq, sk, d):
    plan = pfa.flash_bwd_launch_plan(b, h, sq, sk, d)
    kv, q = plan["dkdv_blocks_per_head"], plan["dq_blocks_per_head"]
    # one launch: a grid row per batch·head holds its dK/dV blocks, then its dQ blocks
    assert plan["grid"] == (kv + q, b * h) and plan["blocks"] == (kv + q) * b * h
    # every key in exactly one dK/dV block, every query in exactly one dQ block, none empty
    assert _rows_once(kv, plan["dkdv_rows"], sk) == list(range(sk))
    assert _rows_once(q, plan["dq_rows"], sq) == list(range(sq))
    assert (kv - 1) * plan["dkdv_rows"] < sk and (q - 1) * plan["dq_rows"] < sq
    # the streamed tiles: every query once for a dK/dV block, every key once for a dQ block
    assert plan["query_tiles"] == -(-sq // 64) and plan["key_tiles"] == -(-sk // 64)
    # the delta pre-pass: one warp a query row, four a block
    assert plan["delta_blocks"] * 4 >= b * h * sq > (plan["delta_blocks"] - 1) * 4


@pytest.mark.parametrize("d", DS)
def test_flash_bwd_plan_fits_shared_memory_and_registers(d):
    plan = pfa.flash_bwd_launch_plan(4, 8, 4096, 4096, d)
    inst, threads = plan["instance_d"], plan["threads"]
    assert plan["smem_bytes"] == max(plan["dkdv_smem_bytes"], plan["dq_smem_bytes"])
    assert plan["smem_bytes"] <= MAX_SMEM
    assert threads == 128 * plan["warpgroups"] and plan["stages"] == 3
    assert plan["dkdv_rows"] == plan["dq_rows"] == 64 * plan["warpgroups"]
    # dK and dV (d/2 each), dQ (d/2), beside S and dP (32 each): a thread's share
    assert plan["dkdv_acc_regs"] == inst and plan["dq_acc_regs"] == inst // 2
    for acc in (plan["dkdv_acc_regs"], plan["dq_acc_regs"]):
        assert acc + 64 <= 255 and (acc + 64) * threads <= REGS_PER_SM
    # the layouts: K, V (or Q, dO) as 64·w-row A tiles, the ring's 64-row tiles
    a_tile = plan["dkdv_rows"] * (-(-inst // 16) * 16) * 2
    kv_tile = 64 * (inst * 2 + 16)
    assert plan["dkdv_smem_bytes"] == 2 * a_tile + 3 * (2 * kv_tile + 2 * 64 * 4)
    assert plan["dq_smem_bytes"] == 2 * a_tile + 3 * 2 * kv_tile


@pytest.mark.parametrize("d,inst", [(8, 40), (16, 40), (24, 40), (40, 40), (48, 80), (64, 80),
                                    (80, 80), (96, 160), (128, 160), (160, 160)])
def test_flash_bwd_instance_is_the_next_one_up(d, inst):
    assert pfa.flash_bwd_instance(d) == inst
    assert pfa.flash_bwd_launch_plan(1, 1, 64, 64, d)["instance_d"] == inst
    assert inst in pfa.FLASH_BWD_INSTANCES


@pytest.mark.parametrize("d", [0, 4, 12, 44, 161, 168, 512])
def test_flash_bwd_plan_refuses_what_the_kernel_does_not_take(d):
    with pytest.raises(ValueError):
        pfa.flash_bwd_launch_plan(1, 2, 128, 128, d)
    with pytest.raises(ValueError):
        pfa.flash_bwd_instance(d)


def test_flash_bwd_plan_at_the_training_shapes():
    """Stage 2 at batch 4: 192 rows a block and three warpgroups at d = 40 and
    80, 128 rows and two at d = 160; one launch for both roles."""
    big = pfa.flash_bwd_launch_plan(4, 8, 4096, 4096, 40)
    assert big["grid"] == (44, 32) and big["threads"] == 384 and big["smem_bytes"] == 75_264
    mid = pfa.flash_bwd_launch_plan(4, 8, 1024, 1024, 80)
    assert mid["grid"] == (12, 32) and mid["threads"] == 384 and mid["smem_bytes"] == 130_560
    small = pfa.flash_bwd_launch_plan(4, 8, 256, 256, 160)
    assert small["grid"] == (4, 32) and small["threads"] == 256
    assert small["smem_bytes"] == 212_480 and small["dq_rows"] == 128
    assert pfa.MAX_BWD_D == 160


def test_flash_bwd_source_names_its_headers_for_the_library_hash():
    """The backward now includes the attention tile pipeline, so an edited
    header rebuilds it with the two forwards."""
    headers = ["attention_core.cuh", "ptx.cuh", "wgmma.cuh"]
    assert cuda_build.source_files("flash_attention_bwd.cu") == ["flash_attention_bwd.cu",
                                                                  *headers]
    for source in ("flash_attention.cu", "packed_flash_attention.cu", "flash_attention_bwd.cu"):
        assert set(headers) <= set(cuda_build.source_files(source))


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__386bdb8f_22_flash_attention_bwd_cu_2531e69914flash_bwd_bf16ILi160EEEvNS_9BwdParamsEi' for 'sm_90a'
    0 bytes stack frame, 68 bytes spill stores, 68 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__386bdb8f_22_flash_attention_bwd_cu_2531e69914flash_bwd_bf16ILi40EEEvNS_9BwdParamsEi' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 156 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__386bdb8f_22_flash_attention_bwd_cu_2531e69910bwd_deltaI13__nv_bfloat16EEvNS_9BwdParamsE' for 'sm_90a'
ptxas info    : Used 30 registers
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__386bdb8f_22_flash_attention_bwd_cu_2531e69917flash_bwd_dkdv_f32ENS_9BwdParamsE' for 'sm_90a'
ptxas info    : Used 32 registers
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__386bdb8f_22_flash_attention_bwd_cu_2531e69915flash_bwd_dq_f32ENS_9BwdParamsE' for 'sm_90a'
ptxas info    : Used 40 registers
"""


def test_ptxas_summary_names_the_backward_kernels():
    got = cuda_build.ptxas_summary(PTXAS_LOG)
    assert [k["kernel"] for k in got] == ["flash_bwd_bf16<160>", "flash_bwd_bf16<40>",
                                          "bwd_delta<bf16>", "flash_bwd_dkdv_f32",
                                          "flash_bwd_dq_f32"]
    assert got[0] == {"kernel": "flash_bwd_bf16<160>", "registers": 255, "spill_stores": 68,
                      "spill_loads": 68}
    assert got[1]["registers"] == 156 and got[1]["spill_stores"] == 0


class _Fn:
    argtypes = None
    restype = None


@pytest.mark.parametrize("with_plan", [True, False])
def test_bind_bwd_declares_the_interface_of_a_library_with_or_without_its_plan(with_plan):
    # a baseline checkout's library may predate c2d_flash_bwd_plan
    names = ["c2d_flash_attention_bwd", "c2d_cuda_error_string_bwd"]
    lib = type("Lib", (), {n: _Fn() for n in names + ["c2d_flash_bwd_plan"] * with_plan})()
    assert pfa._bind_bwd(lib) is lib
    fn = lib.c2d_flash_attention_bwd
    assert len(fn.argtypes) == 19 and fn.restype is not None
    assert lib.c2d_cuda_error_string_bwd.argtypes is not None
    assert hasattr(lib, "c2d_flash_bwd_plan") == with_plan
    if with_plan:
        assert len(lib.c2d_flash_bwd_plan.argtypes) == 6


def test_build_all_builds_each_source_of_the_directory_given(monkeypatch):
    seen = []
    monkeypatch.setattr(cuda_build, "build", lambda src, csrc=None: seen.append((src, csrc)))
    cuda_build.build_all(["a.cu", "b.cu"], "/base/csrc")
    cuda_build.build_all(["c.cu"])
    assert sorted(seen) == [("a.cu", "/base/csrc"), ("b.cu", "/base/csrc"), ("c.cu", None)]
