"""The attack-of-record tools on the port (the repository's ``tools/``):
the attack-quality check, the protocol of record in two stages
(``protocol_prep``, ``protocol_run``), the convergence table, the
full-width stability soak and the loss figure.

    python -m <package>.tools.attack_quality --mini
    python -m <package>.tools.protocol_prep --mini --out DIR
    python -m <package>.tools.protocol_run --train-set DIR/train_set ...
    python -m <package>.tools.convergence_compare
    python -m <package>.tools.soak 200 24
    python -m <package>.tools.plot_history RUN_DIR

Each ``main(argv=None)`` returns its summary dict. The tools take
``--device`` (default ``cuda``; they raise where there is no card) and
pass it to every CLI that takes one. Where the repository's tools run a
CLI as a subprocess, these call the port's CLI module's ``main(argv)`` in
their own process and append its output to ``<out>/cli.log``: the built
kernels and the CUDA context are reused, and a caller can count the
kernels' launches. ``scenes`` holds the port's own copy of the scene
generator the refparity victims were trained on.
"""
