/* Public C ABI for shared-object custom filters.
 *
 * The analog of NNStreamer's NNStreamer_custom vtable
 * (tensor_filter_custom.h): compile a .c/.cc file implementing these
 * exports into a shared object and load it with
 * `tensor_filter framework=custom-so model=/path/libmyfilter.so`.
 * The port's copy of the JAX package's header, the same ABI: a filter built
 * against either loads in both.
 *
 *   g++ -O2 -shared -fPIC myfilter.cc -o libmyfilter.so
 *
 * Lifecycle: nns_init(custom) once at open (optional export), then
 * nns_get_input_spec / nns_get_output_spec once at negotiation, then
 * nns_invoke per frame, then nns_destroy at close (optional export).
 * Output buffers are allocated by the framework from the declared output
 * spec (the reference's allocate_in_invoke=FALSE discipline).
 */

#ifndef NNS_CUSTOM_FILTER_H
#define NNS_CUSTOM_FILTER_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

#define NNS_MAX_TENSORS 16
#define NNS_MAX_RANK 8

/* dtype codes (the order of NNStreamer's _nns_tensor_type,
 * tensor_typedef.h) */
enum nns_dtype {
  NNS_INT32 = 0,
  NNS_UINT32 = 1,
  NNS_INT16 = 2,
  NNS_UINT16 = 3,
  NNS_INT8 = 4,
  NNS_UINT8 = 5,
  NNS_FLOAT64 = 6,
  NNS_FLOAT32 = 7,
  NNS_INT64 = 8,
  NNS_UINT64 = 9,
};

typedef struct {
  int32_t dtype;                 /* enum nns_dtype */
  uint32_t rank;                 /* <= NNS_MAX_RANK */
  uint64_t dims[NNS_MAX_RANK];   /* numpy (row-major, outermost-first) order */
} nns_tensor_spec;

typedef struct {
  uint32_t num_tensors;          /* <= NNS_MAX_TENSORS */
  nns_tensor_spec tensors[NNS_MAX_TENSORS];
} nns_tensors_spec;

/* Required exports.  Return 0 on success, nonzero on error. */
int nns_get_input_spec(nns_tensors_spec *spec);
int nns_get_output_spec(nns_tensors_spec *spec);

/* One frame of work.  in_bufs/out_bufs have num_tensors entries in spec
 * order; sizes are byte lengths.  Write results into the preallocated
 * out_bufs.  Return 0 on success, >0 to drop the frame, <0 on error. */
int nns_invoke(const void *const *in_bufs, const uint64_t *in_sizes,
               void *const *out_bufs, const uint64_t *out_sizes);

/* Optional exports. */
int nns_init(const char *custom);
void nns_destroy(void);

#ifdef __cplusplus
}
#endif

#endif /* NNS_CUSTOM_FILTER_H */
