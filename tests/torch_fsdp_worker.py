"""``launch/train.py``'s loop in the ``fsdp`` regime (ZeRO-3 over every
rank), which its command line does not offer: the reference reaches the
regime only through ``build_cell``.

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        tests/torch_fsdp_worker.py [launch/train.py's arguments]

``tests/test_torch_cuda.py::test_sharded_training_over_every_card`` runs
it over every card against ``launch/train.py`` on one.
"""
import sys

from repro_torch.launch import train

if __name__ == "__main__":
    train.main(sys.argv[1:], regime="fsdp")
