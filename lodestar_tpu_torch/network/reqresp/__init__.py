"""Req/Resp domain: framed request/response protocols.

Reference: `network/reqresp/` — protocol ids, varint + SSZ-snappy (framing
format) encoding strategies (`encodingStrategies/sszSnappy/`), per-protocol
handlers, response codes.
"""

from .protocols import Protocol, PROTOCOLS, protocol_id  # noqa: F401
from .codec import (  # noqa: F401
    RespCode,
    decode_request,
    decode_response_chunks,
    encode_request,
    encode_response_chunk,
    encode_error_chunk,
)
from .handlers import ReqRespHandlers  # noqa: F401
