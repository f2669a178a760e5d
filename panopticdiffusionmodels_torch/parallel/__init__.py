from .mesh import InProcessSP, ProcessGroupSP, SequenceParallel, from_mesh

__all__ = ["InProcessSP", "ProcessGroupSP", "SequenceParallel", "from_mesh"]
