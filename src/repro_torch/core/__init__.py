"""The paper's primary contribution: the IDEA ingestion/enrichment
framework — intake / computing / storage jobs, partition holders,
parameterized predeployed (AOT-compiled) computing jobs, versioned
reference data, and the Q1-Q7 enrichment-UDF workload."""

from repro_torch.core.compaction import (  # noqa: F401
    CompactionJob,
    CompactionSpec,
    CompactionStats,
)
from repro_torch.core.computing import (  # noqa: F401
    ComputingRunner,
    ComputingSpec,
    ComputingStats,
)
from repro_torch.core.durability import (  # noqa: F401
    CheckpointStore,
    DurableSpec,
    FrameLedger,
    IntakeLog,
    ref_fingerprint,
)
from repro_torch.core.elasticity import (  # noqa: F401
    ElasticityController,
    ElasticSpec,
)
from repro_torch.core.feed import FeedConfig, FeedHandle, FeedManager  # noqa: F401
from repro_torch.core.plan import (  # noqa: F401
    IngestPlan,
    Pipeline,
    PlanError,
    SinkSpec,
    StageGroup,
    StoreSpec,
    pipeline,
)
from repro_torch.core.intake import (  # noqa: F401
    Adapter,
    FileAdapter,
    IntakeJob,
    NotResumableError,
    SocketAdapter,
    SyntheticAdapter,
    TrackedFrame,
)
from repro_torch.core.obs import (  # noqa: F401
    FeedHealthModel,
    FeedObs,
    HealthReport,
    HealthSpec,
    HistogramSnapshot,
    JourneyProfiler,
    MetricsRegistry,
    MetricValue,
    ObsServer,
    ProfileReport,
    ProfileSpec,
    Tracer,
    TraceSpec,
)
from repro_torch.core.partition_holder import (  # noqa: F401
    STOP,
    ActivePartitionHolder,
    PartitionHolder,
    PartitionHolderManager,
    StopRecord,
)
from repro_torch.core.predeploy import PredeployCache  # noqa: F401
from repro_torch.core.query import (  # noqa: F401
    Query,
    QueryError,
    QueryResult,
    QueryStats,
    StoreSnapshot,
    agg,
    col,
)
from repro_torch.core.repair import (  # noqa: F401
    RepairJob,
    RepairSpec,
    RepairStats,
)
from repro_torch.core.refdata import (  # noqa: F401
    KEY_SENTINEL,
    RefSnapshot,
    RefStore,
    RefTable,
)
from repro_torch.core.storage import StorageJob, StoragePartition  # noqa: F401
