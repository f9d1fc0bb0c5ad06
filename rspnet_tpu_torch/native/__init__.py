"""Native (C++) components: the FFmpeg video decoder
(port of rspnet_tpu/native)."""
