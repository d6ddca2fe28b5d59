'''
Chemistry parameter tables.

Orbital half-lengths (A) for each reactive-atom type and non-covalent
interaction distance thresholds, with the same keys and values as the
reference tables (TSCoDe's parameters.py:19-78) so that
embedding geometry is reproducible.
'''

# half-length of the TS bonding distance contributed by a given atom type;
# key is '<symbol> <orbital type name>'
ORB_DIM_DICT = {
    'H Single Bond': 0.85,
    'C Single Bond': 1,
    'O Single Bond': 1,
    'N Single Bond': 1,
    'F Single Bond': 1,
    'Cl Single Bond': 1.5,
    'Br Single Bond': 1.5,
    'I Single Bond': 2,

    'C sp': 1,
    'N sp': 1,

    'B sp2': 0.8,
    'C sp2': 1.1,
    'N sp2': 1,

    'B sp3': 1,
    'C sp3': 1,
    'Br sp3': 1,

    'O Ether': 1,
    'S Ether': 1,

    'O Ketone': 0.85,
    'S Ketone': 1,

    'N Imine': 1,

    'C bent carbene': 1,

    'Metal': 2.5,

    'Fallback': 1,
}

# maximum distance (A) for recognized non-covalent interactions;
# tags have the two atom labels in alphabetical order
NCI_DICT = {
    'HO': (2.2, 'O-H hydrogen bond'),
    'HN': (2.2, 'N-H hydrogen bond'),
    'HPh': (2.8, 'H-Ar non-conventional hydrogen bond'),
    'PhPh': (3.8, 'pi-stacking interaction'),
    'FF': (3.5, 'F-F interaction'),
}
