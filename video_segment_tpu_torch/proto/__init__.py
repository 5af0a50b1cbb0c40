"""Wire-compatible protobuf message classes for segmentation results.

Message classes are created dynamically from the serialized descriptor set
committed in `_descriptor.py` (compiled from `segmentation.proto`), so no
`protoc` is needed at run time and there is no protoc-gencode / runtime
version coupling.  The schema matches the reference
(segment_util/segmentation.proto:34-191) field-for-field, so emitted ``.pb``
streams interoperate with the reference tools.
"""

from __future__ import annotations

from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

from video_segment_tpu_torch.proto._descriptor import DESCRIPTOR_SET

_fds = descriptor_pb2.FileDescriptorSet()
_fds.ParseFromString(DESCRIPTOR_SET)
_pool = descriptor_pool.DescriptorPool()
for _f in _fds.file:
    _pool.Add(_f)


def _cls(name: str):
    return message_factory.GetMessageClass(_pool.FindMessageTypeByName(name))


SegmentationDesc = _cls("segmentation.SegmentationDesc")
RegionFeatures = _cls("segmentation.RegionFeatures")

# Nested message conveniences.
Rasterization = SegmentationDesc.Rasterization
ScanInterval = SegmentationDesc.Rasterization.ScanInterval
ShapeMoments = SegmentationDesc.ShapeMoments
VectorMesh = SegmentationDesc.VectorMesh
Polygon = SegmentationDesc.Polygon
Vectorization = SegmentationDesc.Vectorization
Region2D = SegmentationDesc.Region2D
CompoundRegion = SegmentationDesc.CompoundRegion
HierarchyLevel = SegmentationDesc.HierarchyLevel

N4_CONNECT = 1
N8_CONNECT = 2

__all__ = [
    "SegmentationDesc",
    "RegionFeatures",
    "Rasterization",
    "ScanInterval",
    "ShapeMoments",
    "VectorMesh",
    "Polygon",
    "Vectorization",
    "Region2D",
    "CompoundRegion",
    "HierarchyLevel",
    "N4_CONNECT",
    "N8_CONNECT",
]
