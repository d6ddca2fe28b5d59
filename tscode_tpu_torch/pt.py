'''
Periodic-table data for tscode_tpu.

Self-contained replacement for the `periodictable` package used by the
reference (see TSCoDe's pt.py:18-27): we only need element
symbols, covalent radii and atomic masses, so we embed them as flat numpy
arrays (TPU-friendly: they can be gathered on device by atomic number).

Covalent radii are the Cordero et al. 2008 single-bond values (the same
dataset the `periodictable` package ships), in Angstrom. Masses are
standard atomic weights (IUPAC 2021), in amu.
'''

import numpy as np

# fmt: off
SYMBOLS = (
    'X',                                                                # 0 placeholder / dummy
    'H', 'He',
    'Li', 'Be', 'B', 'C', 'N', 'O', 'F', 'Ne',
    'Na', 'Mg', 'Al', 'Si', 'P', 'S', 'Cl', 'Ar',
    'K', 'Ca', 'Sc', 'Ti', 'V', 'Cr', 'Mn', 'Fe', 'Co', 'Ni', 'Cu',
    'Zn', 'Ga', 'Ge', 'As', 'Se', 'Br', 'Kr',
    'Rb', 'Sr', 'Y', 'Zr', 'Nb', 'Mo', 'Tc', 'Ru', 'Rh', 'Pd', 'Ag',
    'Cd', 'In', 'Sn', 'Sb', 'Te', 'I', 'Xe',
    'Cs', 'Ba', 'La', 'Ce', 'Pr', 'Nd', 'Pm', 'Sm', 'Eu', 'Gd', 'Tb',
    'Dy', 'Ho', 'Er', 'Tm', 'Yb', 'Lu',
    'Hf', 'Ta', 'W', 'Re', 'Os', 'Ir', 'Pt', 'Au', 'Hg', 'Tl', 'Pb',
    'Bi', 'Po', 'At', 'Rn',
    'Fr', 'Ra', 'Ac', 'Th', 'Pa', 'U', 'Np', 'Pu', 'Am', 'Cm',
)

# Cordero 2008 covalent radii (Angstrom), indexed by atomic number.
# Carbon uses the sp3 value (0.76), Mn/Fe/Co the high-spin values,
# matching the defaults of the `periodictable` package.
COVALENT_RADII = np.array([
    0.00,                                                               # X
    0.31, 0.28,                                                         # H He
    1.28, 0.96, 0.84, 0.76, 0.71, 0.66, 0.57, 0.58,                     # Li..Ne
    1.66, 1.41, 1.21, 1.11, 1.07, 1.05, 1.02, 1.06,                     # Na..Ar
    2.03, 1.76, 1.70, 1.60, 1.53, 1.39, 1.61, 1.52, 1.50, 1.24, 1.32,   # K..Cu
    1.22, 1.22, 1.20, 1.19, 1.20, 1.20, 1.16,                           # Zn..Kr
    2.20, 1.95, 1.90, 1.75, 1.64, 1.54, 1.47, 1.46, 1.42, 1.39, 1.45,   # Rb..Ag
    1.44, 1.42, 1.39, 1.39, 1.38, 1.39, 1.40,                           # Cd..Xe
    2.44, 2.15, 2.07, 2.04, 2.03, 2.01, 1.99, 1.98, 1.98, 1.96, 1.94,   # Cs..Tb
    1.92, 1.92, 1.89, 1.90, 1.87, 1.87,                                 # Dy..Lu
    1.75, 1.70, 1.62, 1.51, 1.44, 1.41, 1.36, 1.36, 1.32, 1.45, 1.46,   # Hf..Pb
    1.48, 1.40, 1.50, 1.50,                                             # Bi..Rn
    2.60, 2.21, 2.15, 2.06, 2.00, 1.96, 1.90, 1.87, 1.80, 1.69,         # Fr..Cm
], dtype=np.float64)

# Standard atomic weights (amu), indexed by atomic number.
MASSES = np.array([
    0.0,
    1.008, 4.0026,
    6.94, 9.0122, 10.81, 12.011, 14.007, 15.999, 18.998, 20.180,
    22.990, 24.305, 26.982, 28.085, 30.974, 32.06, 35.45, 39.948,
    39.098, 40.078, 44.956, 47.867, 50.942, 51.996, 54.938, 55.845,
    58.933, 58.693, 63.546,
    65.38, 69.723, 72.630, 74.922, 78.971, 79.904, 83.798,
    85.468, 87.62, 88.906, 91.224, 92.906, 95.95, 97.0, 101.07,
    102.91, 106.42, 107.87,
    112.41, 114.82, 118.71, 121.76, 127.60, 126.90, 131.29,
    132.91, 137.33, 138.91, 140.12, 140.91, 144.24, 145.0, 150.36,
    151.96, 157.25, 158.93,
    162.50, 164.93, 167.26, 168.93, 173.05, 174.97,
    178.49, 180.95, 183.84, 186.21, 190.23, 192.22, 195.08, 196.97,
    200.59, 204.38, 207.2,
    208.98, 209.0, 210.0, 222.0,
    223.0, 226.0, 227.0, 232.04, 231.04, 238.03, 237.0, 244.0,
    243.0, 247.0,
], dtype=np.float64)
# fmt: on

assert len(SYMBOLS) == len(COVALENT_RADII) == len(MASSES)

SYMBOL_TO_Z = {s: z for z, s in enumerate(SYMBOLS)}

ELEMENT_NAMES = {
    1: 'hydrogen', 3: 'lithium', 5: 'boron', 6: 'carbon', 7: 'nitrogen',
    8: 'oxygen', 9: 'fluorine', 11: 'sodium', 12: 'magnesium',
    14: 'silicon', 15: 'phosphorus', 16: 'sulfur', 17: 'chlorine',
    19: 'potassium', 20: 'calcium', 30: 'zinc', 35: 'bromine', 53: 'iodine',
}


class _Element:
    '''Minimal element record mimicking `periodictable`'s element objects.'''

    __slots__ = ('number', 'symbol', 'covalent_radius', 'mass', 'name')

    def __init__(self, z):
        self.number = z
        self.symbol = SYMBOLS[z]
        self.covalent_radius = float(COVALENT_RADII[z])
        self.mass = float(MASSES[z])
        self.name = ELEMENT_NAMES.get(z, SYMBOLS[z])

    def __repr__(self):
        return f'<Element {self.symbol} (Z={self.number})>'


class _PeriodicTable:
    '''Indexable by atomic number (int) or symbol (str), like the reference's `pt`.'''

    def __init__(self):
        self._by_z = [_Element(z) for z in range(len(SYMBOLS))]

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._by_z[SYMBOL_TO_Z[key]]
        return self._by_z[int(key)]


pt = _PeriodicTable()


def masses_of(atomnos):
    '''Vector of atomic masses for an array of atomic numbers.'''
    return MASSES[np.asarray(atomnos, dtype=int)]


def covalent_radii_of(atomnos):
    '''Vector of covalent radii for an array of atomic numbers.'''
    return COVALENT_RADII[np.asarray(atomnos, dtype=int)]
