# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: apriltag.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0e\x61priltag.proto\x12\x12\x63om.team766.vision\"V\n\rApriltagProto\x12\x14\n\x0c\x63ollect_time\x18\x01 \x02(\x01\x12\x0e\n\x06tag_id\x18\x02 \x02(\x05\x12\t\n\x01x\x18\x03 \x02(\x01\x12\t\n\x01y\x18\x04 \x02(\x01\x12\t\n\x01z\x18\x05 \x02(\x01\"D\n\x11\x41priltagListProto\x12/\n\x04tags\x18\x01 \x03(\x0b\x32!.com.team766.vision.ApriltagProtoB\x02P\x01')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'apriltag_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'P\001'
  _APRILTAGPROTO._serialized_start=38
  _APRILTAGPROTO._serialized_end=124
  _APRILTAGLISTPROTO._serialized_start=126
  _APRILTAGLISTPROTO._serialized_end=194
# @@protoc_insertion_point(module_scope)
