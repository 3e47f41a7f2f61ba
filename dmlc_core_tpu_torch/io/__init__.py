"""URI-addressed streams, filesystems, RecordIO and sharded input splits
(the port of ``dmlc_core_tpu/io``; reference include/dmlc/io.h,
recordio.h and src/io/)."""

from .uri import URI, URISpec  # noqa: F401
from .stream import (  # noqa: F401
    Stream,
    SeekStream,
    MemoryStream,
    FileStream,
    Serializable,
    StreamIO,
    wrap_text,
)
from .filesystem import (  # noqa: F401
    FileSystem,
    FileInfo,
    LocalFileSystem,
    MemoryFileSystem,
    TemporaryDirectory,
    FS_REGISTRY,
)
from . import codec  # noqa: F401
from .codec import (  # noqa: F401
    DecodeContext,
    DecodedBlockCache,
    available_codecs,
    default_decode_cache,
    default_decode_context,
    get_codec,
)
from . import blockcache  # noqa: F401
from .blockcache import BlockCacheClient, BlockCacheDaemon  # noqa: F401
from .recordio import (  # noqa: F401
    KMAGIC,
    CFLAG_COMPRESSED,
    RecordIOWriter,
    IndexedRecordIOWriter,
    RecordIOReader,
    RecordIOChunkReader,
    decode_chunk,
)
from . import serializer  # noqa: F401
from . import retry  # noqa: F401
from . import faults  # noqa: F401  (registers fault://)
from .retry import RetryPolicy, RetryingReadStream  # noqa: F401
from .faults import FaultInjectingFileSystem  # noqa: F401
from . import lookup  # noqa: F401
from .lookup import LookupClient, LookupServer, RecordLookup  # noqa: F401
from .split import (  # noqa: F401
    InputSplit,
    InputSplitBase,
    LineSplitter,
    RecordIOSplitter,
    IndexedRecordIOSplitter,
    SingleFileSplit,
    ThreadedInputSplit,
    CachedInputSplit,
    InputSplitShuffle,
)
from .split import create as create_input_split  # noqa: F401
