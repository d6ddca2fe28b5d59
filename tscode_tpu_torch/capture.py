'''
Capture of loop bodies in CUDA graphs, shared by the optimizers (FIRE,
the dimer step, the NEB band step), the RMSD prune schedule and the
pipeline's one-program form.

`graph_loop(body, state, args, n_steps)` runs `body(state, args) ->
state` n_steps times from a CUDA graph that is captured once for each
body (`body_key`), device and set of shapes, and kept, least recently
used first out, in a cache of GRAPH_CACHE graphs.
'''

from collections import OrderedDict
import types

import torch

from tscode_tpu_torch.backend import span
from tscode_tpu_torch.ops.kernels._build import device_guard

# captured bodies kept, least recently used first out
GRAPH_CACHE = 8


def map_tensors(tree, fn):
    '''`tree` (a tensor, a tuple or list of trees, or anything else)
    with fn applied to its tensors.'''
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return tuple(map_tensors(t, fn) for t in tree)
    return tree


def _leaves(tree):
    '''The leaves of `tree`, tensors or not, in order.'''
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _tensors(tree):
    return [x for x in _leaves(tree) if isinstance(x, torch.Tensor)]


class GraphLoop:
    '''A loop body `body(state, args) -> state` (state a tuple of
    tensors, args a tree of tensors and constants; the new state has the
    old one's shapes and dtypes) captured once in a CUDA graph over
    tensors of its own. run() copies a problem of the captured shapes
    in, replays the body n_steps times and returns the state. The body
    is kept as long as its graph, and with it whatever its closure
    holds.'''

    def __init__(self, body, state, args):
        self.body = body
        self.state = tuple(s.clone() for s in state)
        self.args = map_tensors(args, torch.clone)
        self.device = self.state[0].device
        # the function that made the body, which names the graph's spans
        # in the --trace profile (e.g. GraphLoop.run:fire_run_graph)
        self.maker = body.__qualname__.split('.<locals>')[0]

        def step():
            for old, new in zip(self.state, body(self.state, self.args)):
                old.copy_(new)

        # capture on the state's card (the current device may be another
        # one), warming up on a side stream, as graph capture asks
        with span(f'GraphLoop.capture:{self.maker}'), \
                device_guard(self.device):
            side = torch.cuda.Stream(device=self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                for _ in range(3):
                    step()
            torch.cuda.current_stream(self.device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                step()

    def run(self, state, args, n_steps):
        with span(f'GraphLoop.run:{self.maker}'), device_guard(self.device):
            for own, new in zip(_tensors(self.args), _tensors(args)):
                own.copy_(new)
            for own, new in zip(self.state, state):
                own.copy_(new)
            for _ in range(n_steps):
                self.graph.replay()
            return tuple(s.clone() for s in self.state)


_graphs = OrderedDict()


def _signature(t):
    return (tuple(t.shape), t.dtype)


def body_key(value):
    '''What a loop body computes, as a key of its captured graph: a
    function as its code, its defaults and, recursively, the values its
    closure holds (so the bodies that one factory makes on equal
    constants share a graph); a tuple or list item by item; anything
    else as itself. A body reads tensors only through its state and
    args: a graph replays the addresses it captured, so a tensor that a
    closure or a default holds would be read from wherever its memory
    has gone once the caller lets it go, and a new value of it would
    never reach the graph. Such a body raises TypeError.'''
    if isinstance(value, torch.Tensor):
        raise TypeError(
            'a captured loop body reads tensors through its state and '
            'args only, not through its closure or defaults')
    if isinstance(value, (tuple, list)):
        return tuple(body_key(x) for x in value)
    if isinstance(value, types.FunctionType):
        return (value.__code__, body_key(value.__defaults__ or ()),
                tuple(body_key(c.cell_contents)
                      for c in value.__closure__ or ()))
    return value


def graph_loop(body, state, args, n_steps):
    '''The state after n_steps calls of body(state, args), replayed
    from a CUDA graph. The body reads tensors through state and args
    only; its closure holds constants (numbers, flags, functions). A
    graph is captured for each (body_key(body), device, shapes and
    dtypes of the state and of the tensors of args, the leaves of args
    that are no tensors, which the capture holds as constants) and kept
    for later calls.'''
    full = (body_key(body), state[0].device,
            tuple(_signature(s) for s in state),
            tuple(_signature(x) if isinstance(x, torch.Tensor) else x
                  for x in _leaves(args)))
    graph = _graphs.pop(full, None)
    if graph is None:
        graph = GraphLoop(body, state, args)
        while len(_graphs) >= GRAPH_CACHE:
            _graphs.popitem(last=False)
    _graphs[full] = graph
    return graph.run(state, args, n_steps)
