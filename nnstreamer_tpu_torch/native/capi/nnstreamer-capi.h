/**
 * nnstreamer-capi.h — C application API for nnstreamer_tpu_torch, the PyTorch/CUDA port.
 *
 * The native analog of the reference's C API layer (survey §2.4:
 * api/capi/include/nnstreamer.h, nnstreamer-capi-single-new.c,
 * nnstreamer-capi-pipeline.c, nnstreamer-capi-util.c): the same two-level
 * surface — `ml_pipeline_*` (construct a pipeline from a launch string,
 * register sink callbacks, push app data, flip valves/switches) and
 * `ml_single_*` (one-shot inference with no pipeline) — plus the
 * `ml_tensors_info_*` / `ml_tensors_data_*` CRUD.
 *
 * Implementation: libnnstreamer_tpu_torch_capi.so embeds CPython and drives the
 * Python framework (nnstreamer_tpu_torch.api.capi_glue); tensor payloads cross
 * the boundary as raw bytes, one copy each way, matching the reference's
 * copy-at-the-app-boundary discipline (ml_tensors_data_create).
 *
 * Thread-safety: every entry point acquires the GIL; callbacks fire on
 * pipeline streaming threads with the GIL held.
 */
#ifndef __NNSTREAMER_TPU_TORCH_CAPI_H__
#define __NNSTREAMER_TPU_TORCH_CAPI_H__

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

#define ML_TENSOR_RANK_LIMIT 8
#define ML_TENSOR_SIZE_LIMIT 16

/** Error codes (0 = success, negative = failure). */
typedef enum {
  ML_ERROR_NONE = 0,
  ML_ERROR_INVALID_PARAMETER = -1,
  ML_ERROR_STREAMS_PIPE = -2,
  ML_ERROR_TRY_AGAIN = -3,
  ML_ERROR_TIMED_OUT = -4,
  ML_ERROR_NOT_SUPPORTED = -5,
  ML_ERROR_UNKNOWN = -6,
  ML_ERROR_OUT_OF_MEMORY = -7,
} ml_error_e;

/** Tensor element types — the reference's 10 types
 * (tensor_typedef.h:85-99) in the same order, plus float16/bfloat16. */
typedef enum {
  ML_TENSOR_TYPE_INT32 = 0,
  ML_TENSOR_TYPE_UINT32,
  ML_TENSOR_TYPE_INT16,
  ML_TENSOR_TYPE_UINT16,
  ML_TENSOR_TYPE_INT8,
  ML_TENSOR_TYPE_UINT8,
  ML_TENSOR_TYPE_FLOAT64,
  ML_TENSOR_TYPE_FLOAT32,
  ML_TENSOR_TYPE_INT64,
  ML_TENSOR_TYPE_UINT64,
  ML_TENSOR_TYPE_FLOAT16,
  ML_TENSOR_TYPE_BFLOAT16,
  ML_TENSOR_TYPE_UNKNOWN,
} ml_tensor_type_e;

/** Pipeline state (subset of GStreamer states the reference reports). */
typedef enum {
  ML_PIPELINE_STATE_NULL = 0,
  ML_PIPELINE_STATE_READY,
  ML_PIPELINE_STATE_PLAYING,
  ML_PIPELINE_STATE_EOS,
  ML_PIPELINE_STATE_UNKNOWN,
} ml_pipeline_state_e;

/** Dimension vector, innermost-last (numpy order; a dim of 0 = unset). */
typedef uint32_t ml_tensor_dimension[ML_TENSOR_RANK_LIMIT];

/* Opaque handles. */
typedef void *ml_tensors_info_h;
typedef void *ml_tensors_data_h;
typedef void *ml_single_h;
typedef void *ml_pipeline_h;
typedef void *ml_pipeline_sink_h;

/** Sink callback: tensors arriving at a registered sink.  `data` and
 * `info` are valid only for the duration of the call. */
typedef void (*ml_pipeline_sink_cb)(const ml_tensors_data_h data,
                                    const ml_tensors_info_h info,
                                    void *user_data);

/* -- runtime ---------------------------------------------------------------
 * Optional: initialize/teardown the embedded interpreter explicitly.  Every
 * API call initializes lazily, so calling these is not required.  When the
 * library is loaded *into* an existing Python process (e.g. via ctypes),
 * the running interpreter is used as-is. */
int ml_tpu_initialize (void);
int ml_tpu_finalize (void);

/* -- ml_tensors_info_* (nnstreamer-capi-util.c parity) -------------------- */
int ml_tensors_info_create (ml_tensors_info_h *info);
int ml_tensors_info_destroy (ml_tensors_info_h info);
int ml_tensors_info_set_count (ml_tensors_info_h info, unsigned int count);
int ml_tensors_info_get_count (ml_tensors_info_h info, unsigned int *count);
int ml_tensors_info_set_tensor_type (ml_tensors_info_h info,
    unsigned int index, ml_tensor_type_e type);
int ml_tensors_info_get_tensor_type (ml_tensors_info_h info,
    unsigned int index, ml_tensor_type_e *type);
/** Set dims; `rank` counts the leading valid entries of `dimension`. */
int ml_tensors_info_set_tensor_dimension (ml_tensors_info_h info,
    unsigned int index, unsigned int rank, const ml_tensor_dimension dimension);
int ml_tensors_info_get_tensor_dimension (ml_tensors_info_h info,
    unsigned int index, unsigned int *rank, ml_tensor_dimension dimension);
/** Byte size of tensor `index` (element size × dims). */
int ml_tensors_info_get_tensor_size (ml_tensors_info_h info,
    unsigned int index, size_t *size);

/* -- ml_tensors_data_* ---------------------------------------------------- */
/** Allocate zero-filled payload buffers shaped by `info`. */
int ml_tensors_data_create (ml_tensors_info_h info, ml_tensors_data_h *data);
int ml_tensors_data_destroy (ml_tensors_data_h data);
/** Borrow a pointer to tensor `index`'s buffer (valid until destroy). */
int ml_tensors_data_get_tensor_data (ml_tensors_data_h data,
    unsigned int index, void **raw, size_t *size);
/** Copy `size` bytes into tensor `index`'s buffer. */
int ml_tensors_data_set_tensor_data (ml_tensors_data_h data,
    unsigned int index, const void *raw, size_t size);

/* -- ml_single_* (one-shot inference; nnstreamer-capi-single-new.c) ------- */
/**
 * Open a model for single-shot inference.
 * @param framework  backend name ("torch", "torch-cpu", "custom-python",
 *                   "custom-so", ...; see nnstreamer_tpu_torch.backends)
 * @param model      model path (backend-specific)
 * @param custom     backend custom string (may be NULL)
 * @param in_info    input spec, or NULL to use the model's own / first-invoke
 */
int ml_single_open (ml_single_h *single, const char *model,
    const char *framework, const char *custom, ml_tensors_info_h in_info);
int ml_single_close (ml_single_h single);
/** Synchronous inference; `*out` is allocated (caller destroys). */
int ml_single_invoke (ml_single_h single, const ml_tensors_data_h in,
    ml_tensors_data_h *out);
int ml_single_get_input_info (ml_single_h single, ml_tensors_info_h *info);
int ml_single_get_output_info (ml_single_h single, ml_tensors_info_h *info);
int ml_single_set_input_info (ml_single_h single, ml_tensors_info_h info);
/** Invoke timeout in milliseconds (0 = none); ML_ERROR_TIMED_OUT on expiry. */
int ml_single_set_timeout (ml_single_h single, unsigned int ms);

/* -- ml_pipeline_* (nnstreamer-capi-pipeline.c) --------------------------- */
/** Build a pipeline from a launch description (gst_parse_launch analog). */
int ml_pipeline_construct (const char *description, ml_pipeline_h *pipe);
int ml_pipeline_destroy (ml_pipeline_h pipe);
int ml_pipeline_start (ml_pipeline_h pipe);
int ml_pipeline_stop (ml_pipeline_h pipe);
int ml_pipeline_get_state (ml_pipeline_h pipe, ml_pipeline_state_e *state);
/** Block until EOS (timeout_ms 0 = forever); ML_ERROR_TIMED_OUT on expiry. */
int ml_pipeline_wait (ml_pipeline_h pipe, unsigned int timeout_ms);

int ml_pipeline_sink_register (ml_pipeline_h pipe, const char *sink_name,
    ml_pipeline_sink_cb cb, void *user_data, ml_pipeline_sink_h *sink);
int ml_pipeline_sink_unregister (ml_pipeline_sink_h sink);

/** Push one frame of tensors into the appsrc element `src_name`. */
int ml_pipeline_src_input_data (ml_pipeline_h pipe, const char *src_name,
    const ml_tensors_data_h data);
int ml_pipeline_src_input_eos (ml_pipeline_h pipe, const char *src_name);

/** Select the active pad of an input/output-selector element. */
int ml_pipeline_switch_select (ml_pipeline_h pipe, const char *switch_name,
    const char *pad_name);
/** Open/close a valve element (open=0 drops frames). */
int ml_pipeline_valve_set_open (ml_pipeline_h pipe, const char *valve_name,
    int open);

#ifdef __cplusplus
}
#endif

#endif /* __NNSTREAMER_TPU_TORCH_CAPI_H__ */
