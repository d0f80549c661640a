"""The JAX package's three demos (``examples/``) on the port:

    python -m fthmc_tpu_torch.examples.demo_2d_u1 [--quick]
    python -m fthmc_tpu_torch.examples.demo_highbeta [--ntraj 128]
    python -m fthmc_tpu_torch.examples.demo_schwinger [--quick]

Each takes the JAX demo's flags with its defaults, plus ``--device`` (the
card by default; ``--device cpu``) and flags that cut its run lengths;
``main(argv)`` prints what the JAX demo prints and returns the numbers as
a dict. Flows come from the exported ``.npz`` files of
``fthmc_tpu_torch/data``.
"""
