"""The JAX package's ``examples/`` as runnable modules of the port:

    python -m repro_torch.examples.quickstart         # scenario sweep + ADCC crash/resume
    python -m repro_torch.examples.cg_crash_recovery  # CG with invariant-scan recovery
    python -m repro_torch.examples.abft_matmul_demo   # ABFT MM, B1 and B2 on the card
    python -m repro_torch.examples.mc_xsbench         # XSBench with selective flushing
    python -m repro_torch.examples.train_e2e          # mamba2-130m with the ADCC trainer

Each runs on the CUDA card by default and on the CPU with ``--device
cpu``; each ``main(argv)`` returns what it printed as a summary dict.
"""
