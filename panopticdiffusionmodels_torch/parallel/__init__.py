from .mesh import DataParallel, InProcessSP, ProcessGroupSP, SequenceParallel, from_mesh

__all__ = ["DataParallel", "InProcessSP", "ProcessGroupSP", "SequenceParallel", "from_mesh"]
