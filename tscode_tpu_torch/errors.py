'''
Exception types for tscode_tpu (parity with TSCoDe's errors.py:18-59).
'''


class ZeroCandidatesError(Exception):
    '''Raised when all embedded candidates have been pruned away.'''


class InputError(Exception):
    '''Raised for malformed input files or inconsistent molecule specs.'''


class TriangleError(Exception):
    '''Raised when three pivot lengths cannot form a triangle (cyclical embed).'''


class CCReadError(Exception):
    '''Raised when a molecular file cannot be parsed.'''


class MopacReadError(Exception):
    '''Raised when a MOPAC output file cannot be parsed.'''


class SegmentedGraphError(Exception):
    '''Raised when a conformational search is attempted on a disconnected graph.'''


class NoOrbitalError(Exception):
    '''Raised when orbital data is requested for a non-reactive atom.'''


class FatalError(Exception):
    '''Raised when a pre-optimization scrambles a structure beyond recovery.'''
