"""Seconds of meshing in set-up: the program's own timers of the octree
(``Octor *``) and of the mesh's material pass."""

NAMES = ("Octor Newtree", "Octor Refinetree", "Octor Balancetree",
         "Octor Extractmesh", "Mesh correct properties")


def read(ctx):
    got = [ctx.timers[n] for n in NAMES if n in ctx.timers]
    return sum(got) if got else None
