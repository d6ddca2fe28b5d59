'''
A stand-in for the `xtb` binary: a test double, not a calculator. No
number it gives is chemistry.

It reads the command lines and the input files that the calculator
adapters of tscode_tpu and tscode_tpu_torch build (an .xyz file, an
optional `--input` file with `$opt` and `$constrain` blocks) and writes
the files those adapters parse: the `logfile=` trajectory with xtb's
`energy:` comment lines and `xtbopt.xyz` for `--opt`, the Turbomole
`gradient` file for `--grad`, and `TOTAL ENERGY` / `TOTAL FREE ENERGY`
lines on standard output. Anything else (`--md`, `$md` or `$metadyn`
blocks, unknown flags) exits with status 1 and a message on standard
error.

The model is small, smooth and deterministic, in Python floats and the
standard library only, so that both packages get bit-identical answers
for byte-identical inputs:

- bonds are found from the input geometry (covalent radii, factor
  1.2), each harmonic (0.3 Eh/A^2) at its input length, and pulled
  weakly (0.05 Eh/A^2) toward the sum of the two covalent radii, so
  that no input geometry is a stationary point;
- pairs neither bonded nor sharing a neighbour repel softly,
  0.02 Eh * exp(-(r - 2) / 0.3);
- `$constrain` distance springs, k (r - r0)^2 with k the file's
  `force constant` (0.5 by default) and `auto` (or anything that is
  not a number, such as the `None` the adapters write for a pairing
  without a target) meaning the input distance; dihedral springs
  k (1 - cos(phi - phi0));
- a constant per atom that depends on the method (-1.0 Eh for GFN2,
  -0.9 for GFN1, -0.5 for `--gfnff`) and -0.05 Eh per unit of charge,
  so the force-field and the QM stages report different energies.

`--opt LVL` takes a fixed number of steepest-descent steps for the
level (`maxcycle` of the input caps it when positive), step 0.1 A^2/Eh
times the force, each atom's move capped at 0.05 A. `--ohess` runs the
`normal` steps and adds 0.01 Eh per bond to the energy as the free
energy; `--bhess` does the same at the input geometry.

    main(argv, cwd, out=None, err=None) -> exit status

runs one call in the directory `cwd` (argv without the program name),
writing what xtb prints to `out` (standard output by default). When the
environment names a file in STANDIN_XTB_CALLS, every call appends its
command line to it, one line a call.
'''

import math
import os
import sys

BOHR = 0.529177210903          # A per Bohr

COVALENT_RADII = {
    'H': 0.31, 'He': 0.28, 'Li': 1.28, 'Be': 0.96, 'B': 0.84, 'C': 0.76,
    'N': 0.71, 'O': 0.66, 'F': 0.57, 'Ne': 0.58, 'Na': 1.66, 'Mg': 1.41,
    'Al': 1.21, 'Si': 1.11, 'P': 1.07, 'S': 1.05, 'Cl': 1.02, 'Ar': 1.06,
    'K': 2.03, 'Ca': 1.76, 'Br': 1.20, 'I': 1.39,
}

OPT_STEPS = {'crude': 5, 'sloppy': 8, 'loose': 12, 'lax': 15,
             'normal': 20, 'tight': 25, 'vtight': 30, 'extreme': 40}

K_BOND, K_PULL = 0.3, 0.05
REP_A, REP_R0, REP_RHO = 0.02, 2.0, 0.3
STEP, MAX_MOVE = 0.1, 0.05
METHOD_CONSTANT = {'gfn2': -1.0, 'gfn1': -0.9, 'gfnff': -0.5}


class StandinError(Exception):
    '''A call the stand-in does not serve (exit status 1).'''


def read_xyz(path):
    with open(path) as f:
        lines = f.read().splitlines()
    n = int(lines[0].split()[0])
    symbols, coords = [], []
    for line in lines[2:2 + n]:
        parts = line.split()
        symbols.append(parts[0])
        coords.append([float(v) for v in parts[1:4]])
    return symbols, coords


def parse_args(argv):
    '''The command line -> dict of what the call asks for.'''
    args = {'xyz': None, 'input': None, 'opt': None, 'grad': False,
            'hess': None, 'method': 'gfn2', 'charge': 0}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == '--input':
            args['input'] = argv[i + 1]
            i += 1
        elif a == '--opt':
            level = 'normal'
            if i + 1 < len(argv) and argv[i + 1] in OPT_STEPS:
                level = argv[i + 1]
                i += 1
            args['opt'] = level
        elif a == '--grad':
            args['grad'] = True
        elif a in ('--ohess', '--bhess'):
            args['hess'] = a[2:]
        elif a == '--gfnff':
            args['method'] = 'gfnff'
        elif a == '--gfn':
            args['method'] = {'1': 'gfn1', '2': 'gfn2'}.get(argv[i + 1])
            if args['method'] is None:
                raise StandinError(f'--gfn {argv[i + 1]} is not served')
            i += 1
        elif a == '--chrg':
            args['charge'] = int(argv[i + 1])
            i += 1
        elif a in ('-P', '--alpb', '--gbsa'):
            i += 1                       # threads and solvent: no effect
        elif a == '--norestart':
            pass
        elif not a.startswith('-') and args['xyz'] is None:
            args['xyz'] = a
        else:
            raise StandinError(f'argument {a!r} is not served by the '
                               f'stand-in')
        i += 1
    if args['xyz'] is None:
        raise StandinError('no .xyz file given')
    return args


def parse_input(path, args):
    '''$opt and $constrain blocks of an xtb input file.'''
    inp = {'logfile': 'xtbopt.log', 'output': 'xtbopt.xyz', 'maxcycle': 0,
           'k': 0.5, 'distances': [], 'dihedrals': []}
    block = None
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line:
                continue
            if line.startswith('$'):
                block = line[1:].split()[0] if len(line) > 1 else ''
                if block in ('md', 'metadyn', 'scc', 'wall'):
                    raise StandinError(f'${block} blocks are not served')
                continue
            key, _, value = line.partition('=') if '=' in line and \
                ':' not in line else line.partition(':')
            key, value = key.strip(), value.strip()
            if block == 'opt' and key in ('logfile', 'output'):
                inp[key] = value
            elif block == 'opt' and key == 'maxcycle':
                inp['maxcycle'] = int(value)
            elif block == 'constrain' and key == 'force constant':
                inp['k'] = float(value)
            elif block == 'constrain' and key == 'distance':
                a, b, d = (v.strip() for v in value.split(','))
                inp['distances'].append((int(a) - 1, int(b) - 1, d))
            elif block == 'constrain' and key == 'dihedral':
                *quad, angle = (v.strip() for v in value.split(','))
                inp['dihedrals'].append(
                    (tuple(int(q) - 1 for q in quad), float(angle)))
            elif block == 'gfn' and key == 'method':
                args['method'] = {'1': 'gfn1', '2': 'gfn2'}[value]
            elif block not in ('opt', 'constrain', 'gfn', 'end'):
                raise StandinError(f'input line {line!r} is not served')
    return inp


def dist(c, i, j):
    return math.sqrt(sum((c[i][k] - c[j][k]) ** 2 for k in range(3)))


def dihedral(c, q):
    '''Dihedral of the four atoms q, degrees.'''
    p = [c[i] for i in q]
    b0 = [p[0][k] - p[1][k] for k in range(3)]
    b1 = [p[2][k] - p[1][k] for k in range(3)]
    b2 = [p[3][k] - p[2][k] for k in range(3)]
    n1 = math.sqrt(sum(v * v for v in b1)) or 1e-12
    b1 = [v / n1 for v in b1]
    d0 = sum(x * y for x, y in zip(b0, b1))
    d2 = sum(x * y for x, y in zip(b2, b1))
    v = [b0[k] - d0 * b1[k] for k in range(3)]
    w = [b2[k] - d2 * b1[k] for k in range(3)]
    x = sum(s * t for s, t in zip(v, w))
    cross = [b1[1] * v[2] - b1[2] * v[1], b1[2] * v[0] - b1[0] * v[2],
             b1[0] * v[1] - b1[1] * v[0]]
    y = sum(s * t for s, t in zip(cross, w))
    return math.degrees(math.atan2(y, x))


def target(coords, a, b, value):
    '''A distance constraint's target: the number, or the input
    distance for `auto` and for a value that is not a number (the
    adapters write `None` for a pairing without a target distance).'''
    try:
        return float(value)
    except ValueError:
        return dist(coords, a, b)


class Model:
    '''The stand-in's energy: bonds, soft repulsion, springs.'''

    def __init__(self, symbols, coords, args, inp):
        n = len(symbols)
        radii = [COVALENT_RADII.get(s, 1.5) for s in symbols]
        self.bonds, nbrs = [], [set() for _ in range(n)]
        for i in range(n):
            for j in range(i + 1, n):
                r = dist(coords, i, j)
                if r < 1.2 * (radii[i] + radii[j]):
                    self.bonds.append((i, j, r, radii[i] + radii[j]))
                    nbrs[i].add(j)
                    nbrs[j].add(i)
        self.pairs = [(i, j) for i in range(n) for j in range(i + 1, n)
                      if j not in nbrs[i] and not nbrs[i] & nbrs[j]]
        k = inp['k'] if inp else 0.5
        self.springs = [(a, b, k, target(coords, a, b, d))
                        for a, b, d in (inp['distances'] if inp else [])]
        self.torsions = [(q, k, angle)
                         for q, angle in (inp['dihedrals'] if inp else [])]
        self.constant = n * METHOD_CONSTANT[args['method']] \
            - 0.05 * args['charge']

    def energy_gradient(self, c):
        n = len(c)
        e = self.constant
        g = [[0.0, 0.0, 0.0] for _ in range(n)]

        def radial(i, j, r, de_dr):
            if r < 1e-12:
                return
            for k in range(3):
                f = de_dr * (c[i][k] - c[j][k]) / r
                g[i][k] += f
                g[j][k] -= f

        for i, j, r0, r_std in self.bonds:
            r = dist(c, i, j)
            e += K_BOND * (r - r0) ** 2 + K_PULL * (r - r_std) ** 2
            radial(i, j, r, 2 * K_BOND * (r - r0) + 2 * K_PULL * (r - r_std))
        for i, j in self.pairs:
            r = dist(c, i, j)
            rep = REP_A * math.exp(-(r - REP_R0) / REP_RHO)
            e += rep
            radial(i, j, r, -rep / REP_RHO)
        for i, j, k, r0 in self.springs:
            r = dist(c, i, j)
            e += k * (r - r0) ** 2
            radial(i, j, r, 2 * k * (r - r0))
        for q, k, angle in self.torsions:
            e += self.torsion_energy(c, q, k, angle)
            h = 1e-5
            for i in q:
                for d in range(3):
                    c[i][d] += h
                    ep = self.torsion_energy(c, q, k, angle)
                    c[i][d] -= 2 * h
                    em = self.torsion_energy(c, q, k, angle)
                    c[i][d] += h
                    g[i][d] += (ep - em) / (2 * h)
        return e, g

    @staticmethod
    def torsion_energy(c, q, k, angle):
        return k * (1 - math.cos(math.radians(dihedral(c, q) - angle)))


def descend(model, c, n_steps, frames):
    '''n_steps capped steepest-descent steps from c; every geometry and
    its energy go to frames. Returns (coords, energy, gradient).'''
    e, g = model.energy_gradient(c)
    frames.append((e, g, [row[:] for row in c]))
    for _ in range(n_steps):
        for i, gi in enumerate(g):
            step = [-STEP * v for v in gi]
            norm = math.sqrt(sum(s * s for s in step))
            if norm > MAX_MOVE:
                step = [s * MAX_MOVE / norm for s in step]
            for k in range(3):
                c[i][k] += step[k]
        e, g = model.energy_gradient(c)
        frames.append((e, g, [row[:] for row in c]))
    return c, e, g


def gnorm(g):
    return math.sqrt(sum(v * v for row in g for v in row))


def xyz_text(symbols, c, comment):
    rows = [f'{len(symbols)}', comment]
    rows += [f'{s:<2} {x:18.10f} {y:18.10f} {z:18.10f}'
             for s, (x, y, z) in zip(symbols, c)]
    return '\n'.join(rows) + '\n'


def energy_line(e, what='TOTAL ENERGY'):
    return f'          | {what:<24}{e:22.12f} Eh   |\n'


def write_gradient(path, symbols, c, e, g):
    '''The Turbomole `gradient` file xtb --grad writes (Bohr, Eh/Bohr,
    Fortran D exponents).'''
    def fortran(v):
        return f'{v:22.14E}'.replace('E', 'D')

    rows = ['$grad',
            f'  cycle =      1    SCF energy = {e:20.12f}   |dE/dxyz| = '
            f'{gnorm(g) * BOHR:10.6f}']
    rows += [f'{x / BOHR:22.14f}{y / BOHR:22.14f}{z / BOHR:22.14f}'
             f'      {s.lower()}' for s, (x, y, z) in zip(symbols, c)]
    rows += [''.join(fortran(v * BOHR) for v in row) for row in g]
    rows.append('$end')
    with open(path, 'w') as f:
        f.write('\n'.join(rows) + '\n')


def run(argv, cwd, out):
    args = parse_args(argv)
    symbols, coords = read_xyz(os.path.join(cwd, args['xyz']))
    inp = parse_input(os.path.join(cwd, args['input']), args) \
        if args['input'] else None
    model = Model(symbols, coords, args, inp)
    out.write(f'      stand-in xtb ({args["method"]}), {len(symbols)} '
              f'atoms\n')
    c = [row[:] for row in coords]

    if args['opt'] is not None or args['hess'] == 'ohess':
        level = args['opt'] or 'normal'
        n_steps = OPT_STEPS[level]
        if inp and inp['maxcycle'] > 0:
            n_steps = min(n_steps, inp['maxcycle'])
        frames = []
        c, e, g = descend(model, c, n_steps, frames)
        logfile = inp['logfile'] if inp else 'xtbopt.log'
        with open(os.path.join(cwd, logfile), 'w') as f:
            for fe, fg, fc in frames:
                f.write(xyz_text(symbols, fc,
                                 f' energy: {fe:.12f} gnorm: '
                                 f'{gnorm(fg):.12f} xtb: 6.6.1 (stand-in)'))
        output = inp['output'] if inp else 'xtbopt.xyz'
        with open(os.path.join(cwd, output), 'w') as f:
            f.write(xyz_text(symbols, c, f' energy: {e:.12f} gnorm: '
                             f'{gnorm(g):.12f} xtb: 6.6.1 (stand-in)'))
    else:
        e, g = model.energy_gradient(c)

    if args['grad']:
        write_gradient(os.path.join(cwd, 'gradient'), symbols, c, e, g)
    out.write(energy_line(e))
    if args['hess'] is not None:
        out.write(energy_line(e + 0.01 * len(model.bonds),
                              'TOTAL FREE ENERGY'))
    out.write('      normal termination of the stand-in xtb\n')


def main(argv, cwd, out=None, err=None):
    '''One call of the stand-in in directory cwd; returns the exit
    status (0, or 1 for a call it does not serve).'''
    out = out if out is not None else sys.stdout
    err = err if err is not None else sys.stderr
    log = os.environ.get('STANDIN_XTB_CALLS')
    if log:
        with open(log, 'a') as f:
            f.write(' '.join(argv) + '\n')
    try:
        run(list(argv), cwd, out)
    except StandinError as e:
        err.write(f'stand-in xtb: {e}\n')
        return 1
    return 0
