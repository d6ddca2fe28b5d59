'''
CLI entry point of the port: `python -m tscode_tpu_torch input.txt
[--device cuda|cpu] [options]` (counterpart of tscode_tpu/__main__.py).

The device defaults to cuda; without a card that raises, and nothing
switches to the CPU on its own: pass `--device cpu` for a CPU run.
`--dtype float64` runs the embed in float64 on the card too.
`--trace DIR` profiles the run on its device (backend.DeviceTrace).
'''

import argparse
import os
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='tscode_tpu_torch',
        description='Transition State Conformational Docker, PyTorch + '
                    'CUDA port')
    parser.add_argument('inputfile', nargs='?',
                        help='input file (.txt DSL)')
    parser.add_argument('--device', default='cuda',
                        help='torch device of the run: cuda (default) or '
                             'cpu')
    parser.add_argument('--dtype', choices=('float32', 'float64'),
                        default=None,
                        help='working dtype of the embed (default: float32 '
                             'on cuda, float64 on cpu)')
    parser.add_argument('-n', '--name', default=None,
                        help='custom name stamp for the run')
    parser.add_argument('-cl', '--command-line', dest='cl', default=None,
                        help='pass the input text directly on the command '
                             'line')
    parser.add_argument('-t', '--test', action='store_true',
                        help='run installation smoke tests on --device')
    parser.add_argument('-p', '--profile', action='store_true',
                        help='profile the run with cProfile')
    parser.add_argument('--procs', type=int, default=None,
                        help='cores per external QM job')
    parser.add_argument('--threads', type=int, default=None,
                        help='concurrent external QM jobs')
    parser.add_argument('-r', '--restart', default=None,
                        help='resume from a tscode_resume_*.pkl state file')
    parser.add_argument('-b', '--benchmark', action='store_true',
                        help='run the proc/thread tuning benchmark on the '
                             'input file (internal-FF FIRE on --device '
                             'without xtb)')
    parser.add_argument('-s', '--setup', action='store_true',
                        help='guided calculator setup (writes overrides '
                             'to ~/.tscode_tpu_settings.json)')
    parser.add_argument('-c', '--cite', action='store_true',
                        help='print the literature citation and exit')
    parser.add_argument('--trace', metavar='DIR', default=None,
                        help='capture a torch.profiler device profile of '
                             'the run into DIR (open with tensorboard or '
                             'Perfetto); the device-level analog of -p '
                             'host profiling')
    args = parser.parse_args(argv)

    if args.cite:
        from tscode_tpu_torch.references import references
        print(references['TSCoDe'])
        return 0

    if args.setup:
        from tscode_tpu_torch.modify_settings import run_setup
        run_setup()
        return 0

    if args.test:
        from tscode_tpu_torch.tests_install import run_tests
        run_tests(args.device)
        return 0

    if args.cl is not None:
        filename = os.path.abspath('tscode_tpu_cl_input.txt')
        with open(filename, 'w') as f:
            f.write(args.cl.replace(';', '\n') + '\n')
    elif args.inputfile is not None:
        filename = os.path.abspath(args.inputfile)
    else:
        parser.print_help()
        return 2

    if args.benchmark:
        from tscode_tpu_torch.concurrent_test import run_concurrent_test
        run_concurrent_test(filename, device=args.device)
        return 0

    import torch

    from tscode_tpu_torch.embedder import Embedder

    def _run():
        embedder = Embedder(filename, stamp=args.name, procs=args.procs,
                            threads=args.threads, device=args.device,
                            dtype=args.dtype and getattr(torch, args.dtype))
        embedder.run(resume_from=args.restart)

    def _cprofile(fn):
        import cProfile
        import pstats
        with cProfile.Profile() as pr:
            fn()
        pstats.Stats(pr).sort_stats('cumtime').print_stats(30)

    run = (lambda: _cprofile(_run)) if args.profile else _run
    if args.trace:
        # DeviceTrace resolves the device before the profiler starts
        # (cuda without a card raises there), as the JAX CLI pins its
        # backend before jax.profiler.trace
        from tscode_tpu_torch.backend import DeviceTrace
        with DeviceTrace(args.trace, args.device) as trace:
            run()
        print(f'tscode_tpu_torch: device trace written to {trace.path}')
    else:
        run()
    return 0


if __name__ == '__main__':
    sys.exit(main())
