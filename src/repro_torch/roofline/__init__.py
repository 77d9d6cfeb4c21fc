"""Cost model of the port: the H100's constants (``hw``), a FLOP and
byte counter over aten ops that also takes the hand kernels' charges
(``op_cost``; each kernel's charge lies beside its wrapper in
``kernels/*/ops.py``), and the roofline built from them (``analysis``)."""
