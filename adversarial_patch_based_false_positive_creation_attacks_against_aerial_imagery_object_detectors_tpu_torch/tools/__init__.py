"""The repository's ``tools/`` on the port: the attack-of-record tools
(the attack-quality check, the protocol of record in two stages
``protocol_prep`` and ``protocol_run``, the convergence table, the
full-width stability soak and the loss figure), the serving and training
measurement tools (``serving_throughput``, ``detector_throughput``,
``serve_soak``, ``perf_breakdown``, ``step_profile``), the warp
quality A/Bs (``warp_ab``, ``warp_dtype_ab``) and the A/B micro tools of
the stem, the 152^2 stage and the victim's convs (``stem_ab``,
``stem_fused_ab``, ``c12_ab``, ``c12_micro``, ``conv_micro``,
``s2dx_poly_ab``); and the repository's root entry points, the step
bench of its ``bench.py`` (``bench``) and the flagship forward and
multi-rank dryrun of its ``__graft_entry__.py`` (``entry``).

    python -m <package>.tools.attack_quality --mini
    python -m <package>.tools.protocol_prep --mini --out DIR
    python -m <package>.tools.protocol_run --train-set DIR/train_set ...
    python -m <package>.tools.convergence_compare
    python -m <package>.tools.soak 200 24
    python -m <package>.tools.plot_history RUN_DIR
    python -m <package>.tools.serving_throughput 2048 8 16 uint8
    python -m <package>.tools.detector_throughput 16
    python -m <package>.tools.serve_soak --duration 1800
    python -m <package>.tools.perf_breakdown 8
    python -m <package>.tools.step_profile 8 10
    python -m <package>.tools.warp_ab
    python -m <package>.tools.warp_dtype_ab
    python -m <package>.tools.stem_ab 8 608
    python -m <package>.tools.stem_fused_ab 8 608
    python -m <package>.tools.c12_ab grad [c12]
    python -m <package>.tools.c12_ab step 24 [c12]
    python -m <package>.tools.c12_micro 24
    python -m <package>.tools.conv_micro 8
    python -m <package>.tools.s2dx_poly_ab 8
    python -m <package>.tools.bench
    python -m <package>.tools.entry 8

Each ``main(argv=None)`` returns its summary dict. The tools take
``--device`` (default ``cuda``; they raise where there is no card) and
pass it to every CLI that takes one. Where the repository's tools run a
CLI as a subprocess, these call the port's CLI module's ``main(argv)`` in
their own process and append its output to ``<out>/cli.log``: the built
kernels and the CUDA context are reused, and a caller can count the
kernels' launches. ``scenes`` holds the port's own copy of the scene
generator the refparity victims were trained on, ``victims`` its copy of
the crafted brightness victim the warp A/Bs attack. The measurement
tools time with CUDA events, or the host's clock between
``torch.cuda.synchronize`` calls, and compile nothing but the kernels;
the micro tools time back-to-back calls between CUDA events
(``utils/profiling.py: time_calls``) and list the rows that read under
``HOST_BOUND_MS`` a call, whose time the host's launch path sets. The
root entry points start processes of their own (a time-bounded card
probe, the bench's children, the dryrun's ranks:
``parallel/mesh.py: count_cards``, ``run_ranks``) and print one record
as the repository's scripts do.
"""
