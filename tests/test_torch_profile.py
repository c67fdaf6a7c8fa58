"""``launch/profile.py``'s kernel classes, on the CPU: every ``__global__``
function of ``src/repro_torch/csrc/<kernel>.cu`` lands in its kernel's
class under the names a trace gives it (demangled and mangled), before
the library classes whose words its name may hold ("gemm", "scan"), and
library kernels land in theirs."""
import re
from pathlib import Path

import pytest

from repro_torch.launch.profile import KERNEL_ENTRIES, kernel_class

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _entries():
    """(kernel, entry) of every __global__ function in the sources."""
    found = []
    for cu in sorted(CSRC.glob("*.cu")):
        for name in re.findall(r"__global__\s+void\s+(?:__\w+__\([^)]*\)\s*)*"
                               r"(\w+)\s*\(", cu.read_text()):
            found.append((cu.stem, name))
    return found


ENTRIES = _entries()


def test_entries_match_the_sources():
    by_kernel = {}
    for kernel, name in ENTRIES:
        by_kernel.setdefault(kernel, set()).add(name)
    assert by_kernel == {k: set(v) for k, v in KERNEL_ENTRIES.items()}


@pytest.mark.parametrize("kernel,entry", ENTRIES,
                         ids=[f"{k}-{e}" for k, e in ENTRIES])
def test_hand_written_kernel_classes(kernel, entry):
    demangled = (f"void (anonymous namespace)::{entry}<__nv_bfloat16, 2>"
                 f"(int const*, float*, int)")
    mangled = f"_ZN12_GLOBAL__N_1{len(entry)}{entry}ILi2EEEvPKiPfi"
    assert kernel_class(demangled) == f"{kernel} kernel"
    assert kernel_class(mangled) == f"{kernel} kernel"


@pytest.mark.parametrize("name,want", [
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
     "matmul (cuBLAS)"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT", "matmul (cuBLAS)"),
    ("void at::native::(anonymous namespace)::radixSortKVInPlace<-2, -1>",
     "sort / scatter / scan / search (MoE dispatch, penalties)"),
    ("Memcpy HtoD (Pageable -> Device)", "copies"),
    ("void at::native::vectorized_elementwise_kernel<4, float>",
     "other PyTorch kernels"),
])
def test_library_kernel_classes(name, want):
    assert kernel_class(name) == want
