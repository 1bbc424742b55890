"""The port's ground rules.

* ``src/repro_torch`` and ``chip_smoke.py`` import neither JAX nor the
  JAX package ``repro``, so the port installs alone on a GPU host;
* entry points default to ``device="cuda"`` and raise, rather than run
  on the CPU, where CUDA is absent;
* every TPU kernel the port has ported has its CUDA source, which opens
  with a note naming the kernel it replaces;
* ``chip_smoke.py`` refuses to run without a card or without the port,
  and its bf16 limit admits one rounding of a kernel's output but not a
  skipped KV tile, nor, on an int8 cache, a zeroed V scale, nor for B8 a
  zeroed X tile;
* ``chip_smoke.py``'s ssm-wave gates (every B8 call held to the plain
  version on its own inputs; each SSD layer, fed the plain route's
  input, held to the plain route) admit B8's output times 1 + 1e-6 and
  reject a wrong B8: its output times 1 + 1e-3, a zeroed X tile, a
  skipped diagonal tile, L without its diagonal, an undecayed state;
* a bf16 tensor reaches B1, B2, B3, B5, B8, B6 (on bf16 and int8 pools)
  and, on bf16 caches, B4 and B7 only through their tensor-core forms,
  chosen by dtype in the wrapper, with no ``try`` to fall back from, and
  ``chip_smoke.py`` counts each kernel's tensor-core instructions.
"""

from __future__ import annotations

import ast
import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_smoke
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import mas_attention as tmas
from repro_torch.kernels import paged_decode_attention as ppdec
from repro_torch.kernels import paged_prefill_attention as ppre
from repro_torch.kernels import paged_verify_attention as ppver
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.kernels.common import quantize_q8
from repro_torch.models.api import build_model
from repro_torch.serving import ContinuousBatchingEngine, ServingEngine
from repro_torch.weights import params_from_jax

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"

# TPU kernel (file, body) -> the port's CUDA source, for every ported kernel
PORTED = {
    "B1": ("src/repro/kernels/mas_attention.py", "_mas_resident_kernel",
           "mas_attention.cu"),
    "B2": ("src/repro/kernels/mas_attention.py", "_mas_streamed_kernel",
           "mas_attention.cu"),
    "B3": ("src/repro/kernels/flash_attention.py", "_flash_kernel",
           "flash_attention.cu"),
    "B4": ("src/repro/kernels/decode_attention.py", "_decode_kernel",
           "decode_attention.cu"),
    "B5": ("src/repro/kernels/paged_prefill_attention.py",
           "_paged_prefill_kernel", "paged_prefill_attention.cu"),
    "B6": ("src/repro/kernels/paged_decode_attention.py",
           "_paged_decode_kernel", "paged_decode_attention.cu"),
    "B7": ("src/repro/kernels/paged_verify_attention.py",
           "_paged_verify_kernel", "paged_verify_attention.cu"),
    "B8": ("src/repro/kernels/ssd_scan.py", "_ssd_chunk_kernel",
           "ssd_scan.cu"),
}


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "scripts" / "trace_continuous.py",
        REPO / "scripts" / "copy_rate.py",
        REPO / "scripts" / "ssm_logits_sensitivity.py",
        REPO / "scripts" / "b5_variants.py",
        REPO / "scripts" / "b8_variants.py"],
    ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_no_reference(path):
    for name in _imports(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), (path, name)


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")


def test_entry_points_default_to_cuda_and_raise_without_it():
    _no_cuda()
    cfg = get_smoke("internlm2-1.8b")
    model = build_model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        model.init(seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        model.make_cache(1, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        model.make_cache(1, 8, cache_layout="paged")
    params = model.init(seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(model, params)
    with pytest.raises(RuntimeError, match="cuda"):
        ContinuousBatchingEngine(model, params)
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_jax({}, cfg)


@pytest.mark.parametrize("kernel", sorted(PORTED))
def test_ported_kernel_has_cuda_source_naming_what_it_replaces(kernel):
    tpu_file, body, source = PORTED[kernel]
    assert body in (REPO / tpu_file).read_text()
    cu = PORT / "kernels" / "csrc" / source
    head = cu.read_text().split("#include")[0]
    assert Path(tpu_file).relative_to("src").as_posix() in head
    assert "bound" in head
    assert source.removesuffix(".cu") in _build.SOURCES


def test_kernel_build_is_keyed_by_source_and_refuses_without_nvcc():
    for name in _build.SOURCES:
        path = _build._library_path(name)
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(f"lib{name}-")
        assert set(_build.SIGNATURES[name]) <= set(
            (_build.CSRC / f"{name}.cu").read_text().replace("(", " ").split())
    assert _build.dtype_code(torch.float32) == 0
    assert _build.dtype_code(torch.bfloat16) == 1
    with pytest.raises(TypeError):
        _build.dtype_code(torch.float16)
    pointer_args = [a for sig in _build.SIGNATURES.values()
                    for args in sig.values() for a in args]
    assert ctypes.c_void_p in pointer_args
    if _build.shutil.which("nvcc") is None and not Path(
            "/usr/local/cuda/bin/nvcc").exists():
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.nvcc()


def test_chip_smoke_refuses_without_a_card_or_the_port(tmp_path):
    _no_cuda()
    here = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300,
                          cwd=REPO)
    assert here.returncode != 0 and '"ok"' not in here.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    lone = subprocess.run([sys.executable, str(alone)], capture_output=True,
                          text=True, timeout=300, cwd=tmp_path)
    assert lone.returncode != 0 and '"ok"' not in lone.stdout


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("kernel", [
    "mas", "flash", "decode", "paged_decode", "paged_prefill",
    "paged_verify", "decode_int8", "paged_decode_int8", "paged_prefill_int8",
    "paged_verify_int8", "ssd"])
def test_chip_smoke_bf16_limit_admits_one_rounding_not_a_skipped_tile(
        kernel):
    smoke = _chip_smoke()
    gen = torch.Generator().manual_seed(5)

    def rnd(*shape):
        return torch.randn(shape, generator=gen)

    if kernel == "ssd":
        # the model's decays (a·dt of -0.7 to -11 a step) over 4 heads of
        # 2 chunks of 128 rows; the fault: one cell's last X tile zeroed,
        # which both y's rows and the cell's state must see
        x, b, c = rnd(4, 2, 128, 16), rnd(4, 2, 128, 32), rnd(4, 2, 128, 32)
        a = -torch.nn.functional.softplus(rnd(4, 2, 128)) * torch.linspace(
            1.0, 16.0, 4)[:, None, None]
        want = tssd.ssd_intra_chunk_plain(x, a, b, c)
        faulty = tssd.ssd_intra_chunk_plain(
            smoke.drop_x_tile(x, (2, 1), 1), a, b, c)
        for got, ref, bad in zip(want, want, faulty):
            check = smoke.held_to_plain(got.bfloat16(), ref, bad)
            assert 0 < check["row_rel_err"] <= smoke.BF16_ROW_RTOL
            assert check["fault_row_rel_err"] > 10 * smoke.BF16_ROW_RTOL
        return

    int8 = kernel.endswith("_int8")
    kernel = kernel.removesuffix("_int8")
    if kernel.startswith("paged"):
        kp, vp = rnd(2, 40, 16, 64), rnd(2, 40, 16, 64)
        ks = vs = None
        if int8:        # the fault: the page's V scale zeroed
            (kp, ks), (vp, vs) = (quantize_q8(x, (-2, -1)) for x in (kp, vp))
        table = (torch.randperm(39, generator=gen) + 1)[:32].view(2, 16).to(
            torch.int32)
        if kernel == "paged_decode":
            q = rnd(2, 2, 2, 64)
            lens = torch.tensor([200, 256], dtype=torch.int32)

            def plain(vp, vs):
                return ppdec.paged_decode_attention_plain(
                    q, kp, vp, table, lens, n_split=2, tiles_per_split=2,
                    k_scales=ks, v_scales=vs)
        elif kernel == "paged_verify":
            q = rnd(2, 2, 4 * 2, 64)
            lens = torch.tensor([200, 256], dtype=torch.int32)

            def plain(vp, vs):
                return ppver.paged_verify_attention_plain(
                    q, kp, vp, table, lens, lens - 4, spec=4, n_split=2,
                    tiles_per_split=2, k_scales=ks, v_scales=vs)
        else:
            q = rnd(4, 64, 64)

            def plain(vp, vs):
                return ppre.paged_prefill_attention_plain(
                    q, kp, vp, table[1],
                    torch.tensor([192, 256], dtype=torch.int32), blk_q=32,
                    k_scales=ks, v_scales=vs)
        want = plain(vp, vs)
        # the second-last live page of the longest sequence skipped
        page = int(table[1, 14])
        faulty = (plain(vp, smoke.drop_scale_page(vs, page)) if int8
                  else plain(smoke.drop_v_page(vp, page), vs))
        check = smoke.held_to_plain(want.bfloat16(), want, faulty)
        assert 0 < check["row_rel_err"] <= smoke.BF16_ROW_RTOL
        assert check["fault_row_rel_err"] > 10 * smoke.BF16_ROW_RTOL
        return
    if kernel == "decode" and int8:
        q = rnd(4, 2, 64)
        (k, ks), (v, vs) = (quantize_q8(rnd(4, 256, 64), -1)
                            for _ in range(2))
        lens = torch.tensor([1, 70, 200, 256], dtype=torch.int32)

        def plain(vs):
            return tdec.decode_attention_plain(q, k, v, lens, n_split=2,
                                               tiles_per_split=2, k_scale=ks,
                                               v_scale=vs)

        want = plain(vs)
        check = smoke.held_to_plain(want.bfloat16(), want,
                                    plain(smoke.drop_scale_tile(vs, 2)))
        assert 0 < check["row_rel_err"] <= smoke.BF16_ROW_RTOL
        assert check["fault_row_rel_err"] > 10 * smoke.BF16_ROW_RTOL
        return
    if kernel == "decode":
        q, k, v = rnd(4, 2, 64), rnd(4, 256, 64), rnd(4, 256, 64)
        lens = torch.tensor([1, 70, 200, 256], dtype=torch.int32)

        def plain(v):
            return tdec.decode_attention_plain(q, k, v, lens, n_split=2,
                                               tiles_per_split=2)
    else:
        q, k, v = rnd(8, 256, 64), rnd(4, 256, 64), rnd(4, 256, 64)
        fn = (tmas.mas_attention_plain if kernel == "mas"
              else tflash.flash_attention_plain)

        def plain(v):
            return fn(q, k, v, blk_q=32, blk_kv=64, causal=True)

    want = plain(v)
    # held_to_plain itself fails unless the skipped tile breaks the limit
    check = smoke.held_to_plain(want.bfloat16(), want,
                                plain(smoke.drop_v_tile(v, 2)))
    assert 0 < check["row_rel_err"] <= smoke.BF16_ROW_RTOL
    assert check["fault_row_rel_err"] > 10 * smoke.BF16_ROW_RTOL


def test_chip_smoke_ptxas_report_names_each_kernel():
    # two entries of an nvcc -Xptxas -v log: registers and spill bytes
    # land under each kernel, in the log's order
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN5repro20split_combine_kernelIfEEvPKfS2_S2_PT_iii' for 'sm_90a'",
        "ptxas info    : Function properties for "
        "_ZN5repro20split_combine_kernelIfEEvPKfS2_S2_PT_iii",
        "    8 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 80 registers, used 1 barriers, 400 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_Z6kernelv' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 32 registers, used 0 barriers",
        # B4's tensor-core forms on bf16 and int8 caches, its merge pass,
        # and B7's at 32 rows on an int8 pool
        "ptxas info    : Compiling entry function '_ZN52_GLOBAL__N__408c5d7c"
        "_19_decode_attention_cu_daae7df818decode_bf16_kernelILi128E13__nv_"
        "bfloat16EEvPKS1_PKT0_S6_PKfS8_PKiPfSB_SB_iiif' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN52_GLOBAL__N__408c5d7c"
        "_19_decode_attention_cu_daae7df818decode_bf16_kernelILi128EaEEvPK13"
        "__nv_bfloat16PKT0_S6_PKfS8_PKiPfSB_SB_iiif' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 127 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN52_GLOBAL__N__408c5d7c"
        "_19_decode_attention_cu_daae7df824decode_bf16_merge_kernelILi128EEE"
        "vPKfS2_S2_PKiP13__nv_bfloat16iiii' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 1 barriers, 4352 bytes smem",
        "ptxas info    : Compiling entry function '_ZN58_GLOBAL__N__be15b586"
        "_25_paged_verify_attention_cu_daae7df824paged_verify_bf16_kernelILi"
        "128ELi2EaEEvPK13__nv_bfloat16PKT1_S6_PKfS8_PKiSA_SA_PfSB_SB_iiiiiii"
        "f' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 246 registers, used 1 barriers",
        # B6's tensor-core form on an int8 pool and its merge pass
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_124paged_"
        "decode_bf16_kernelILi128EaEEvPK13__nv_bfloat16PKT0_S6_PKfS8_PKiSA_"
        "PfSB_SB_iiiiiif' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 154 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_130paged_"
        "decode_bf16_merge_kernelILi128EEEvPKfS2_S2_PKiP13__nv_bfloat16iiiii'"
        " for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 1 barriers, 4352 bytes smem",
    ])
    report = _chip_smoke().ptxas_report(log)
    assert list(report.values()) == [
        {"spill_bytes": 12, "registers": 80},
        {"spill_bytes": 0, "registers": 32},
        {"spill_bytes": 0, "registers": 128},
        {"spill_bytes": 0, "registers": 127},
        {"spill_bytes": 0, "registers": 40},
        {"spill_bytes": 0, "registers": 246},
        {"spill_bytes": 0, "registers": 154},
        {"spill_bytes": 0, "registers": 40}]
    names = list(report)
    assert "split_combine_kernel" in names[0] and "kernel" in names[1]
    assert "decode_bf16_kernel<128, __nv_bfloat16>" in names[2]
    assert "decode_bf16_kernel<128, signed char>" in names[3]
    assert "decode_bf16_merge_kernel" in names[4]
    assert "paged_verify_bf16_kernel<128, 2, signed char>" in names[5]
    assert "paged_decode_bf16_kernel" in names[6]
    assert "paged_decode_bf16_merge_kernel" in names[7]
    assert _chip_smoke().ptxas_report("") == {}


def test_chip_smoke_sass_report_counts_tensor_core_instructions():
    # two functions of a cuobjdump -sass listing: mma.sync (HMMA) and
    # wgmma (HGMMA) instructions land under each, in the listing's order
    listing = "\n".join([
        "\tcode for sm_90a",
        "\t\tFunction : _ZN12_GLOBAL__N_117flash_bf16_kernelILi128EEEvPK"
        "13__nv_bfloat16S3_S3_PS1_iiiiiiif",
        "\t.headerflags\t@\"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS\"",
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;",
        "        /*0a30*/                   HMMA.16816.F32.BF16 R24, R4, R20,"
        " R24 ;                    /* 0x000000140418723c */",
        "        /*0a40*/                   HMMA.16816.F32.BF16 R28, R4, R22,"
        " R28 ;",
        "        /*0a50*/                   LDSM.16.MT88.4 R8, [R2+UR4] ;",
        "\t\tFunction : _Z6kernelv",
        "        /*0100*/                   HGMMA.64x64x16.F32.BF16 R24, "
        "gdesc[UR4], R24 ;",
        "        /*0110*/                   FFMA R1, R2, R3, R1 ;",
        # B1's bf16 form: mma.sync; B5's: wgmma with a transposed B
        "\t\tFunction : _ZN12_GLOBAL__N_124mas_resident_bf16_kernelILi128E"
        "Li2ELb0EEEvPK13__nv_bfloat16S3_S3_PS1_iiiiiif",
        "        /*0200*/                   LDSM.16.M88.4 R4, [R2] ;",
        "        /*0210*/                   HMMA.16816.F32.BF16 R8, R4, R12,"
        " R8 ;",
        "\t\tFunction : _ZN12_GLOBAL__N_125paged_prefill_bf16_kernelILi128"
        "EaEEvPK13__nv_bfloat16PKT0_S6_PKfS8_PKiPS1_iiiiiif",
        "        /*0300*/                   WARPGROUP.ARRIVE ;",
        "        /*0310*/                   HGMMA.64x64x16.F32.BF16 R24, R88, "
        "gdesc[UR8], RZ, !UPT ;",
        "        /*0320*/                   HGMMA.64x128x16.F32.BF16 R56, R24,"
        " gdesc[UR8].tnspB, R56 ;",
        "        /*0330*/                   HGMMA.64x128x16.F32.BF16 R56, R28,"
        " gdesc[UR8].tnspB, R56, gsb0 ;",
        # B4's and B7's tensor-core forms: mma.sync fed by ldmatrix (.trans
        # for V), B4 on a bf16 cache, B7 on an int8 pool (bytes permuted
        # to bf16 first)
        "\t\tFunction : _ZN52_GLOBAL__N__408c5d7c_19_decode_attention_cu_"
        "daae7df818decode_bf16_kernelILi128E13__nv_bfloat16EEvPKS1_PKT0_S6_"
        "PKfS8_PKiPfSB_SB_iiif",
        "        /*0400*/                   LDSM.16.MT88.4 R20, [R3+0x1000] ;",
        "        /*0410*/                   HMMA.16816.F32.BF16 R24, R8, R20,"
        " R24 ;",
        "        /*0420*/                   HMMA.16816.F32.BF16 R24, R12, R20,"
        " R24 ;",
        "\t\tFunction : _ZN58_GLOBAL__N__be15b586_25_paged_verify_attention"
        "_cu_daae7df824paged_verify_bf16_kernelILi128ELi1EaEEvPK13__nv_"
        "bfloat16PKT1_S6_PKfS8_PKiSA_SA_PfSB_SB_iiiiiiif",
        "        /*0480*/                   PRMT R5, R4, 0x7440, R9 ;",
        "        /*0500*/                   HMMA.16816.F32.BF16 R4, R8, R12,"
        " R4 ;",
        # B6's tensor-core forms, on a bf16 and on an int8 pool
        "\t\tFunction : _ZN12_GLOBAL__N_124paged_decode_bf16_kernelILi128E13"
        "__nv_bfloat16EEvPKS1_PKT0_S6_PKfS8_PKiSA_PfSB_SB_iiiiiif",
        "        /*0600*/                   HMMA.16816.F32.BF16 R4, R8, R12,"
        " R4 ;",
        "\t\tFunction : _ZN12_GLOBAL__N_124paged_decode_bf16_kernelILi128EaEE"
        "vPK13__nv_bfloat16PKT0_S6_PKfS8_PKiSA_PfSB_SB_iiiiiif",
        "        /*0700*/                   PRMT R5, R4, 0x7440, R9 ;",
        "        /*0710*/                   HMMA.16816.F32.BF16 R4, R8, R12,"
        " R4 ;",
        "        /*0720*/                   HMMA.16816.F32.BF16 R4, R8, R14,"
        " R4 ;",
    ])
    report = _chip_smoke().sass_report(listing)
    assert list(report.values()) == [{"hmma": 2, "hgmma": 0},
                                     {"hmma": 0, "hgmma": 1},
                                     {"hmma": 1, "hgmma": 0},
                                     {"hmma": 0, "hgmma": 3},
                                     {"hmma": 2, "hgmma": 0},
                                     {"hmma": 1, "hgmma": 0},
                                     {"hmma": 1, "hgmma": 0},
                                     {"hmma": 2, "hgmma": 0}]
    names = list(report)
    assert "flash_bf16_kernel" in names[0]
    assert "mas_resident_bf16_kernel" in names[2]
    assert "paged_prefill_bf16_kernel" in names[3]
    assert "decode_bf16_kernel<128, __nv_bfloat16>" in names[4]
    assert "paged_verify_bf16_kernel<128, 1, signed char>" in names[5]
    assert "paged_decode_bf16_kernel<128, __nv_bfloat16>" in names[6]
    assert "paged_decode_bf16_kernel<128, signed char>" in names[7]
    assert _chip_smoke().sass_report("") == {}


B8_VARIANTS = ("scaled_1e-6", "scaled_1e-3", "zeroed_x_tile",
               "skipped_diagonal_tile", "dropped_l_diagonal",
               "undecayed_state")


def _b8_variant(smoke, name):
    plain = tssd.ssd_intra_chunk_plain
    if name == "scaled_1e-6":
        return smoke.b8_scaled(plain, 1e-6)
    return smoke.b8_faults(plain)[name]


@pytest.mark.parametrize("variant", B8_VARIANTS)
def test_chip_smoke_b8_gate_admits_a_rounding_not_a_wrong_b8(variant):
    """Gate 1 of the ssm wave on one B8 call: the model's decays (a·dt of
    -0.7 to -11 a step) over 4 heads of 2 chunks of 128 rows. Its output
    times 1 + 1e-6 passes the 1e-4 row limit, each wrong B8 fails it, and
    the planted zeroed X tile fails it in y and in the state."""
    smoke = _chip_smoke()
    gen = torch.Generator().manual_seed(6)

    def rnd(*shape):
        return torch.randn(shape, generator=gen)

    x, b, c = (rnd(4, 2, 128, w).bfloat16() for w in (16, 32, 32))
    a = -torch.nn.functional.softplus(rnd(4, 2, 128)) * torch.linspace(
        1.0, 16.0, 4)[:, None, None]
    got = _b8_variant(smoke, variant)(x, a, b, c)
    check = smoke.b8_call_check(got, x, a, b, c)
    assert check["fault_row_rel_err"] > 100 * smoke.SSD_FP32_ROW_RTOL
    if variant == "scaled_1e-6":
        assert 0 < check["row_rel_err"] <= smoke.SSD_FP32_ROW_RTOL / 10
    else:
        assert check["row_rel_err"] > smoke.SSD_FP32_ROW_RTOL


@pytest.mark.parametrize("variant", ["scaled_1e-6", "zeroed_x_tile"])
def test_chip_smoke_ssm_gates_on_the_mamba2_smoke_model(variant):
    """Both ssm-wave gates through a prefill of the mamba2 smoke model in
    bf16 on the CPU (a 200-row prompt: six 32-row chunks and a ragged
    tail): each sees one B8 call and one SSD layer a layer; B8's output
    times 1 + 1e-6 passes both, a zeroed X tile fails both, and each
    gate's planted fault fails it."""
    import dataclasses

    smoke = _chip_smoke()
    cfg = dataclasses.replace(get_smoke("mamba2-130m"), attn_impl="kernel",
                              compute_dtype=torch.bfloat16)
    model = build_model(cfg)
    plain = build_model(dataclasses.replace(cfg, attn_impl="plain"))
    params = model.init(seed=0, device="cpu", dtype=torch.bfloat16)
    prompt = torch.randint(3, cfg.vocab_size, (1, 200),
                           generator=torch.Generator().manual_seed(2))
    b8 = _b8_variant(smoke, variant)
    for run, gate, calls in (
            (smoke.b8_gate(model, params, prompt)[1], smoke.b8_gate(
                model, params, prompt, b8, plant=False)[1], "calls"),
            (smoke.ssd_layer_gate(model, plain, params, prompt)[1],
             smoke.ssd_layer_gate(model, plain, params, prompt, b8,
                                  plant=False)[1], "layers")):
        assert run[calls] == gate[calls] == cfg.num_layers
        assert run["row_rel_err"] <= run["limit"] < run["fault_row_rel_err"]
        if variant == "scaled_1e-6":
            assert gate["row_rel_err"] <= gate["limit"]
        else:
            assert gate["row_rel_err"] > gate["limit"]


def test_bf16_prefill_never_reaches_the_cuda_core_code():
    # the wrappers choose the C function by dtype ...
    bf16, fp32 = torch.bfloat16, torch.float32
    assert tmas.entry_point(bf16, False) == "mas_streamed_bf16_launch"
    assert tmas.entry_point(fp32, False) == "mas_streamed_fp32_launch"
    assert tmas.entry_point(bf16, True) == "mas_resident_bf16_launch"
    assert tmas.entry_point(fp32, True) == "mas_resident_fp32_launch"
    assert tflash.entry_point(bf16) == "flash_attention_bf16_launch"
    assert tflash.entry_point(fp32) == "flash_attention_fp32_launch"
    assert tssd.entry_point(bf16) == "ssd_intra_chunk_bf16_launch"
    assert tssd.entry_point(fp32) == "ssd_intra_chunk_fp32_launch"
    assert ppre.entry_point(bf16) == "paged_prefill_bf16_launch"
    assert ppre.entry_point(fp32) == "paged_prefill_fp32_launch"
    # B4, B6 and B7: a bf16 q on the tensor cores on bf16 and on int8
    # caches (the int8 entry point picks the form by the query's dtype
    # code), an fp32 q on the CUDA cores
    for mod, stem in ((tdec, "decode"), (ppver, "paged_verify"),
                      (ppdec, "paged_decode")):
        assert mod.entry_point(bf16, False) == f"{stem}_bf16_launch"
        assert mod.entry_point(fp32, False) == f"{stem}_fp32_launch"
        assert mod.entry_point(bf16, True) == f"{stem}_int8_launch"
        assert mod.entry_point(fp32, True) == f"{stem}_int8_launch"
    for fn in (lambda: tmas.entry_point(torch.float16, False),
               lambda: tmas.entry_point(torch.float16, True),
               lambda: tflash.entry_point(torch.float16),
               lambda: ppre.entry_point(torch.float16),
               lambda: tdec.entry_point(torch.float16, False),
               lambda: ppver.entry_point(torch.float16, True),
               lambda: ppdec.entry_point(torch.float16, False),
               lambda: tssd.entry_point(torch.float16)):
        with pytest.raises(TypeError):
            fn()
    sigs = {**_build.SIGNATURES["mas_attention"],
            **_build.SIGNATURES["flash_attention"],
            **_build.SIGNATURES["paged_prefill_attention"],
            **_build.SIGNATURES["decode_attention"],
            **_build.SIGNATURES["paged_verify_attention"],
            **_build.SIGNATURES["paged_decode_attention"],
            **_build.SIGNATURES["ssd_scan"]}
    for name in ("mas_streamed_bf16_launch", "mas_streamed_fp32_launch",
                 "mas_resident_bf16_launch", "mas_resident_fp32_launch",
                 "flash_attention_bf16_launch",
                 "flash_attention_fp32_launch", "paged_prefill_bf16_launch",
                 "paged_prefill_fp32_launch", "decode_bf16_launch",
                 "decode_fp32_launch", "decode_int8_launch",
                 "paged_verify_bf16_launch", "paged_verify_fp32_launch",
                 "paged_verify_int8_launch", "paged_decode_bf16_launch",
                 "paged_decode_fp32_launch", "paged_decode_int8_launch",
                 "ssd_intra_chunk_bf16_launch",
                 "ssd_intra_chunk_fp32_launch"):
        assert name in sigs
    assert "ssd_intra_chunk_launch" not in sigs
    # ... with no try to fall back from ...
    for module in (tmas, tflash, ppre, tdec, ppver, ppdec, tssd):
        tree = ast.parse(Path(module.__file__).read_text())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    # ... and the CUDA-core forms of B1, B2, B3, B5 and B8 exist only in
    # fp32
    csrc = PORT / "kernels" / "csrc"
    mas_cu = (csrc / "mas_attention.cu").read_text()
    flash_cu = (csrc / "flash_attention.cu").read_text()
    ppre_cu = (csrc / "paged_prefill_attention.cu").read_text()
    assert "mas_streamed_kernel<float>" in mas_cu
    assert "mas_streamed_kernel<__nv_bfloat16>" not in mas_cu
    assert "mas_resident_kernel<float>" in mas_cu
    assert "mas_resident_kernel<__nv_bfloat16>" not in mas_cu
    assert "flash_kernel<float>" in flash_cu
    assert "flash_kernel<__nv_bfloat16>" not in flash_cu
    assert "launch<float, float>" in ppre_cu
    assert "launch<float, int8_t>" in ppre_cu
    assert "paged_prefill_kernel<__nv_bfloat16" not in ppre_cu
    assert "launch<__nv_bfloat16," not in ppre_cu
    ssd_cu = (csrc / "ssd_scan.cu").read_text()
    assert "launch<float>" in ssd_cu and "ssd_chunk_kernel<T>" in ssd_cu
    assert "ssd_chunk_kernel<__nv_bfloat16>" not in ssd_cu
    assert "launch<__nv_bfloat16>" not in ssd_cu
    assert "Unpack<__nv_bfloat16>" not in ssd_cu
    bf16_launch = ssd_cu[ssd_cu.index("ssd_intra_chunk_bf16_launch("):]
    bf16_launch = bf16_launch[:bf16_launch.index("\n}\n")]
    assert "ssd_chunk_bf16_kernel<<<" in bf16_launch
    assert "launch<" not in bf16_launch
    # ... and of B4, B6 and B7 for an fp32 q only, on fp32 and int8
    # caches: a bf16 q, on bf16 or int8 caches, never reaches them. Each
    # int8 entry point sends a bf16 q (dtype code 1) to the tensor-core
    # form on int8 K/V and an fp32 q to the CUDA-core one.
    dec_cu = (csrc / "decode_attention.cu").read_text()
    ver_cu = (csrc / "paged_verify_attention.cu").read_text()
    pdec_cu = (csrc / "paged_decode_attention.cu").read_text()
    for cu, kernel, cuda_core in (
            (dec_cu, "decode_bf16_kernel", "launch<float, "),
            (ver_cu, "paged_verify_bf16_kernel", "paged_split_launch<float, "),
            (pdec_cu, "paged_decode_bf16_kernel",
             "paged_split_launch<float, ")):
        assert f"{cuda_core}float" in cu and f"{cuda_core}int8_t" in cu
        assert "launch<__nv_bfloat16" not in cu
        assert "paged_split_dispatch" not in cu
        assert f"{kernel}<E, KV>" in cu or f"{kernel}<E, MT, KV>" in cu
        assert "dispatch_tc<__nv_bfloat16>" in cu
        int8_launch = cu[cu.index("_int8_launch("):]
        assert int8_launch.index("dispatch_tc<int8_t>") < int8_launch.index(
            f"{cuda_core}int8_t")
        assert "if (dtype != 0)" in int8_launch
        assert '#include "decode_tc.cuh"' in cu
    # ... and the CUDA-core helpers of common.cuh take no bf16 operand
    common = (csrc / "common.cuh").read_text()
    assert "__nv_bfloat16" not in common.split("#include")[-1]
