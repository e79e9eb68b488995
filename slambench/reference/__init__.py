"""The plain reference that decides ``correct``: the port's frame step
(``filter/srukf.slam_step`` and what it calls), frozen here as it stood when
the benchmark was made, in plain torch operations.

Against the port's modules of the same names: every hand-written kernel is
its plain version (``ops/vision.py``, ``ops/linalg.py``), every gate is read
on the host (``ops/control.py``: no CUDA graph), the Cholesky is
``torch.linalg.cholesky_ex``, no mesh is ever ambient, and
:mod:`.forcing` lets a frame take the program's decision at a knife edge.
It imports nothing of the port, of the JAX package or of JAX, takes the
program's state only as the state a frame starts from, and works out
everything else again. Later changes to the port do not change it.
"""
