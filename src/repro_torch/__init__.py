"""PyTorch + CUDA port of the batch-inference system, for one NVIDIA H100.

A package beside the JAX reference ``repro`` that mirrors its layout
module for module and imports none of it (nor JAX).  Plain tensor code is
PyTorch; each kernel the JAX package wrote in Pallas for the TPU is a
hand-written Hopper kernel here (``kernels/``, sources in ``csrc/``),
with a plain PyTorch version beside it that runs for CPU tensors.  Entry
points take ``device=``, default ``"cuda"``, and raise without a card
unless the caller asks for ``"cpu"``.

Ported so far: serving of dense and MoE decoders
(``runtime/engine.py::NodeEngine`` driven by the copied scheduler and
``runtime/api.py::BatchMaster``) and of the SSM at model level, with all
five kernels; and the batch-job surface: write-ahead ledgers, the
streaming job driver (``launch/job.py``), the long-tail request stream,
the cluster simulator and checkpoints.
"""
