'''
CLI entry point of the port: `python -m tscode_tpu_torch input.txt
[--device cuda|cpu] [options]` (counterpart of tscode_tpu/__main__.py).

The device defaults to cuda; without a card that raises, and nothing
switches to the CPU on its own: pass `--device cpu` for a CPU run.
`--dtype float64` runs the embed in float64 on the card too.
'''

import argparse
import os
import sys

NOT_PORTED_FLAGS = {
    'test': ('-t/--test (installation smoke tests, tests_install.py)', 15),
    'benchmark': ('-b/--benchmark (proc/thread tuning, concurrent_test.py)',
                  15),
    'trace': ('--trace (device profile of the run)', 6),
}


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
                        help='run installation smoke tests (not ported)')
    parser.add_argument('-p', '--profile', action='store_true',
                        help='profile the run with cProfile')
    parser.add_argument('--procs', type=int, default=None,
                        help='cores per external QM job')
    parser.add_argument('--threads', type=int, default=None,
                        help='concurrent external QM jobs')
    parser.add_argument('-r', '--restart', default=None,
                        help='resume from a tscode_resume_*.pkl state file')
    parser.add_argument('-b', '--benchmark', action='store_true',
                        help='proc/thread tuning benchmark (not ported)')
    parser.add_argument('-s', '--setup', action='store_true',
                        help='guided calculator setup (writes overrides '
                             'to ~/.tscode_tpu_settings.json)')
    parser.add_argument('-c', '--cite', action='store_true',
                        help='print the literature citation and exit')
    parser.add_argument('--trace', metavar='DIR', default=None,
                        help='device profile of the run (not ported)')
    args = parser.parse_args(argv)

    for flag, (what, item) in NOT_PORTED_FLAGS.items():
        if getattr(args, flag):
            print(f'tscode_tpu_torch: {what} is not ported yet (ROADMAP.md '
                  f'item {item}); use python -m tscode_tpu', file=sys.stderr)
            return 2

    if args.cite:
        from tscode_tpu_torch.references import references
        print(references['TSCoDe'])
        return 0

    if args.setup:
        from tscode_tpu_torch.modify_settings import run_setup
        run_setup()
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

    import torch

    from tscode_tpu_torch.embedder import Embedder

    def _run():
        embedder = Embedder(filename, stamp=args.name, procs=args.procs,
                            threads=args.threads, device=args.device,
                            dtype=args.dtype and getattr(torch, args.dtype))
        embedder.run(resume_from=args.restart)

    if args.profile:
        import cProfile
        import pstats
        with cProfile.Profile() as pr:
            _run()
        pstats.Stats(pr).sort_stats('cumtime').print_stats(30)
    else:
        _run()
    return 0


if __name__ == '__main__':
    sys.exit(main())
